// B6: one-launch k-way merge of sorted runs, one output block per CTA, and
// the k-way split that cuts the runs into those blocks.
//
// Replaces repro/kernels/kway_kernel.py:147 (_kway_kernel): there each grid
// step double-buffers async copies of the k run segments of the next output
// block into two VMEM slots (2 slots x k runs x B per lane), masks their
// tails to the sentinel tuple, and runs a block-granularity loser tree of
// pairwise merge networks, keeping the low B each round; and its split,
// computed in jnp inside the same jit (kway_kernel.py:226-236): a key
// tournament of ceil(log2 k) rounds of pairwise merges of the compare lanes
// and a source-index lane, the inverse permutation, then a searchsorted of
// each run's ranks over the block bounds (the cursor matrix).
//
// The stable k-way merge has one result under this order: the compare
// prefix (an order-preserving refinement of the tuple), then run index,
// then in-run index. So any correct stable merge gives the bits of
// merge_runs_kway_take, float ties included, and no network is needed.
//
// The split (kway_split_round, one call a tournament round): every merge
// of the round's adjacent pairs of segments in two launches over all pairs,
// B5's algorithm with an explicit lane stride (merge_path.cuh). The
// segments live in one (n_cmp + 1, total) stack — the compare lanes as order
// keys, then the flat source index — ping-ponged between two buffers; the
// first round reads the compare lanes as they are (order keys taken at
// load) and each element's index is its position. An odd last segment is
// merged with an empty one: copied through. A host-built table (uploaded
// once a call) gives each round's pairs: their offset, lengths and the
// prefix of their output blocks, so a warp finds its pair from its
// boundary and a CTA from its block by a binary search. Merges take b
// only where b < a strictly and the lower segment is always a, so a before
// b composes to run-index order. Per round:
//  - kway_split_kernel: a warp a block boundary of every pair, the 33-ary
//    co-rank search of B5's split over the stack;
//  - kway_round_kernel: a CTA a 256-slot output block of every pair, B5's
//    merge (stage with cp.async, order keys, a co-rank search a thread and
//    two outputs), writing the keys and index lane of the next round; the
//    last round writes the inverse instead, rank[index] = position;
//  - then, after the last round, kway_cursor_kernel: cursors[r][j] = base_r
//    + #{elements of run r ranked below j * block}. Run r's ranks ascend, so
//    element i (rank q, its predecessor's q') is the cursor of every j with
//    q' < j * block <= q, and the run's end is the cursor past its last
//    rank: each entry is written once, a thread an element, and a thread a
//    run for the tail.
// 2 ceil(log2 k) + 1 launches a call (12 + 1 at k = 57), against the torch
// split's k - 1 merges of a dozen ops each and k searchsorted calls.
//
// The gather (kway_gather_lanes) lays the runs' lanes end to end in one
// (lanes, total) stack for the split and the merge, the reference's jnp
// concatenation (kway_kernel.py:238): a thread an element, its run by a
// binary search over the bases in shared memory, one word of every lane
// read from the run's own tensor (address and stride from the plan).
//
// The merge (kway_kernel): CTA j reads column j and j + 1 of the cursor
// matrix, scans the k counts into tile offsets (a warp-shuffle block scan,
// looped where k exceeds the CTA's threads), and stages its k segments one
// after the other into a B-wide tile with cp.async, consecutive threads on
// consecutive slots: every data lane (as many a pass as fit in shared
// memory) and the compare lanes, which are read from the first pass when
// they lead the data lanes, turned once into order keys. The segments are
// sorted runs, so they are merged, not sorted: a tree of ceil(log2 k)
// rounds of pairwise merges inside the tile, runs [2mw, 2mw + w) against
// [2mw + w, 2mw + 2w) at w = 2^t, the reference's loser tree. Each thread
// takes two outputs a round: it finds its pair from the run of its first
// output, searches its co-rank in the pair and steps, b only where b < a
// strictly. A round writes each output's slot and its lane-0 key into the
// other of two buffers, one barrier a round (6 at k = 57, against the 36
// stages of the window sort this replaces); a compare reads the two
// lane-0 keys where they sit and the other lanes through the slots, a lane
// at a time, only on a tie. Then consecutive threads write consecutive
// outputs of every data lane from the tile. Of the variants timed on the
// H100 (PERF.md, PR 17) this was the fastest: keys moving whole, slots alone
// moving, whole-lane compares and four outputs a thread were slower.
//
// Shared memory: (n_cmp + 5 + lanes a pass) x B x 4 B plus 2k + 33 ints:
// 20.6 KB at the pipeline's 5 compare lanes, 10 data lanes, B = 256 and k
// = 57. The split's rounds take (n_cmp + 2) x 256 x 4 B a CTA.
//
// What bounds them on the H100: the merge reads every data lane once and
// writes it once (the compare lanes, when they lead the data lanes, are
// read again from L2), so the least time is those bytes over 3.35 TB/s.
// The split's least is the compare lanes read once and the cursor matrix
// written; its rounds move (n_cmp + 1) lanes in and out ceil(log2 k) times,
// and its co-rank searches are latency-bound, a round trip a step.
#include "merge_path.cuh"

#define MAX_RUNS 1024
// outputs a thread merges in a round of the split
#define ROUND_E 2
#define CURSOR_THREADS 256
#define GATHER_THREADS 256

// Inclusive prefix sum of `v` over the threads of the block (blockDim.x a
// multiple of 32); `warp_sums` is 32 ints of shared memory.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int n_warps = blockDim.x >> 5;
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      int u = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += u;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  return warp > 0 ? v + warp_sums[warp - 1] : v;
}

// the last i in [0, n) with sorted[i] <= x (sorted[0] <= x)
__device__ __forceinline__ int last_at_most(const int* sorted, int n, long long x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (sorted[mid] <= x) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Tile positions x < y of B6's merge tree by key: lane 0's order key moves
// with the positions (k0), the other lanes stay in their slots and are
// read through the positions (slot) only where lane 0 ties.
template <int NC>
__device__ __forceinline__ bool tree_less(const uint32_t* k0, const int* slot,
                                          const uint32_t* key, int block,
                                          int n_cmp, int x, int y) {
  const uint32_t p = k0[x], q = k0[y];
  if (p != q) return p < q;
  const int n = NC > 0 ? NC : n_cmp;
  const int sx = slot[x], sy = slot[y];
#pragma unroll
  for (int l = 1; l < n; ++l) {
    const uint32_t u = key[l * block + sx], v = key[l * block + sy];
    if (u != v) return u < v;
  }
  return false;
}

// NC: the compare-lane count, 0 for a count read at run time (10 to 15)
template <int NC>
__global__ void __launch_bounds__(1024)
kway_kernel(const uint32_t* cmp, const uint32_t* data, uint32_t* out,
            const int* cursors, int n_cmp_rt, int n_arr, uint32_t codes,
            int total, int n_runs, int nblocks, int block, int group) {
  const int n_cmp = NC > 0 ? NC : n_cmp_rt;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* key = smem;                                  // n_cmp x block
  uint32_t* k0 = smem + (size_t)n_cmp * block;           // 2 x block
  int* perm = (int*)(k0 + 2 * block);                    // 2 x block
  int* rid = perm + 2 * block;                           // block: slot's run
  uint32_t* tile = (uint32_t*)(rid + block);             // group x block
  int* offs = (int*)(tile + (size_t)group * block);      // n_runs + 1
  int* curs = offs + n_runs + 1;                         // n_runs
  int* warp_sums = curs + n_runs;                        // 32
  const int j = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int E = block / T;

  // the tile offsets of the runs' segments: a scan of their counts, T runs
  // at a time
  if (tid == 0) offs[0] = 0;
  for (int r0 = 0; r0 < n_runs; r0 += T) {
    const int r = r0 + tid;
    int count = 0;
    if (r < n_runs) {
      const int* row = cursors + (size_t)r * (nblocks + 1);
      curs[r] = row[j];
      count = row[j + 1] - row[j];
    }
    const int carry = r0 > 0 ? offs[r0] : 0;
    const int incl = block_inclusive_scan(count, warp_sums) + carry;
    if (r < n_runs) offs[r + 1] = incl;
    __syncthreads();  // offs[r0 + T] and warp_sums, for the next chunk
  }
  const int filled = offs[n_runs];

  // stage the thread's slots tid + e T, consecutive threads on consecutive
  // slots: each slot's run, then its compare lanes (unless they lead the
  // data lanes, whose first pass then holds them) and the first pass of
  // data lanes
  const bool keys_in_tile = cmp == data && n_cmp <= group;
  for (int e = 0; e < E; ++e) {
    const int s = tid + e * T;
    if (s >= filled) break;
    const int r = last_at_most(offs, n_runs, s);
    rid[s] = r;
    const size_t src = (size_t)curs[r] + (s - offs[r]);
    if (!keys_in_tile)
      for (int l = 0; l < n_cmp; ++l)
        cp_async4(key + l * block + s, cmp + (size_t)l * total + src);
  }
  cp_async_commit();
  int lanes = min(group, n_arr);
  for (int e = 0; e < E; ++e) {
    const int s = tid + e * T;
    if (s >= filled) break;
    const int r = rid[s];
    const size_t src = (size_t)curs[r] + (s - offs[r]);
    for (int l = 0; l < lanes; ++l)
      cp_async4(tile + l * block + s, data + (size_t)l * total + src);
  }
  cp_async_commit();
  // this thread's keys have landed
  if (keys_in_tile)
    cp_async_wait<0>();
  else
    cp_async_wait<1>();
  const uint32_t* raw = keys_in_tile ? tile : key;
  for (int s = tid; s < filled; s += T) {
    for (int l = 0; l < n_cmp; ++l)
      key[l * block + s] = order_bits(raw[l * block + s], (codes >> (2 * l)) & 3);
    perm[s] = s;
  }
  __syncthreads();

  // the merge tree: round w merges runs [2mw, 2mw + w) and [2mw + w, 2mw +
  // 2w) of the tile, two outputs a thread; pin[o] is the slot holding
  // output o and kin[o] its lane-0 key, both written anew each round
  for (int s = tid; s < filled; s += T) k0[s] = key[s];
  __syncthreads();
  const int d0 = tid * E;
  int* pin = perm;
  int* pout = perm + block;
  uint32_t* kin = k0;
  uint32_t* kout = k0 + block;
  for (int w = 1; w < n_runs; w <<= 1) {
    int pair = -1, a_lo = 0, a_hi = 0, ca = 0, cb = 0, i = 0, jb = 0;
    for (int e = 0; e < E && d0 + e < filled; ++e) {
      const int pos = d0 + e;
      const int q = rid[pos] / (2 * w);
      if (q != pair) {  // the first output, or the first of the next pair:
        pair = q;       // its co-rank in the pair, a binary search
        const int r_lo = q * 2 * w;
        a_lo = offs[r_lo];
        a_hi = offs[min(n_runs, r_lo + w)];
        ca = a_hi - a_lo;
        cb = offs[min(n_runs, r_lo + 2 * w)] - a_hi;
        const int d = pos - a_lo;
        int lo = max(0, d - cb), hi = min(d, ca);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (tree_less<NC>(kin, pin, key, block, n_cmp, a_hi + d - 1 - mid,
                            a_lo + mid))
            hi = mid;
          else
            lo = mid + 1;
        }
        i = lo;
        jb = d - lo;
      }
      const bool take_b =
          jb < cb && (i >= ca || tree_less<NC>(kin, pin, key, block, n_cmp,
                                               a_hi + jb, a_lo + i));
      const int from = take_b ? a_hi + jb++ : a_lo + i++;
      kout[pos] = kin[from];
      pout[pos] = pin[from];
    }
    __syncthreads();
    int* t = pin;
    pin = pout;
    pout = t;
    uint32_t* u = kin;
    kin = kout;
    kout = u;
  }
  cp_async_wait<0>();
  __syncthreads();

  uint32_t* o_base = out + (size_t)j * block;
  for (int first = 0; first < n_arr; first += group) {
    if (first > 0) {
      lanes = min(group, n_arr - first);
      __syncthreads();  // every read of the previous lanes is done
      for (int s = tid; s < filled; s += T) {
        const int r = rid[s];
        const size_t src = (size_t)curs[r] + (s - offs[r]);
        for (int l = 0; l < lanes; ++l)
          cp_async4(tile + l * block + s,
                    data + (size_t)(first + l) * total + src);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int o = tid; o < filled; o += T) {
      const int p = pin[o];
      for (int l = 0; l < lanes; ++l)
        o_base[(size_t)(first + l) * total + o] = tile[l * block + p];
    }
  }
}

// --- the split ----------------------------------------------------------------
//
// A round's table (int32): off[npairs], na[npairs], nb[npairs] (pair p's
// a-segment is [off, off + na) of the stack, its b-segment the nb elements
// after it), then first[npairs + 1], the prefix of the pairs' output
// blocks. Pair p's boundaries are first[p] + p .. first[p + 1] + p: its
// blocks and its end.

// the pair of the round that holds boundary g: the last p with first[p] +
// p <= g
__device__ __forceinline__ int pair_of_boundary(const int* first, int npairs,
                                                int g) {
  int lo = 0, hi = npairs - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (first[mid] + mid <= g) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <int NC>
__global__ void __launch_bounds__(SPLIT_THREADS)
kway_split_kernel(const uint32_t* __restrict__ in, int* starts,
                  const int* __restrict__ table, int npairs, int nbounds,
                  int n_cmp, uint32_t codes, int total, int block) {
  const int lane = threadIdx.x & 31;
  const int g = (int)(((long long)blockIdx.x * SPLIT_THREADS + threadIdx.x) >> 5);
  if (g >= nbounds) return;  // the whole warp
  const int* first = table + 3 * npairs;
  const int p = pair_of_boundary(first, npairs, g);
  const long long d = (long long)(g - first[p] - p) * block;
  const int na = table[npairs + p], nb = table[2 * npairs + p];
  const uint32_t* a = in + table[p];
  const long long lo =
      warp_corank<NC>(a, total, na, a + na, total, nb, d, n_cmp, codes);
  if (lane == 0) {
    const long long jb = d - lo;
    starts[g] = (int)lo;
    starts[nbounds + g] = (int)(jb < nb ? jb : nb);
  }
}

// `in`: the round's stack, n_cmp lanes (raw bits in the first round, order
// keys after it) of lane stride `total`; `in_idx`: its index lane, or null
// in the first round (an element's index is its position). Writes the next
// round's keys and index lane to `out`, or, with `rank`, the last round's
// inverse permutation.
template <int NC>
__global__ void __launch_bounds__(1024)
kway_round_kernel(const uint32_t* in, const uint32_t* in_idx, uint32_t* out,
                  int* rank, const int* starts, const int* table, int npairs,
                  int nbounds, int n_cmp_rt, uint32_t codes, int total,
                  int block) {
  const int n_cmp = NC > 0 ? NC : n_cmp_rt;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* key = smem;                                   // n_cmp x block
  uint32_t* idx = smem + (size_t)n_cmp * block;           // block
  int* src = (int*)(idx + block);                         // block
  const int c = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int* first = table + 3 * npairs;
  const int p = last_at_most(first, npairs, c);
  const int kk = c - first[p], g = first[p] + p + kk;
  const int sa = starts[g], sb = starts[nbounds + g];
  const int ca = max(0, min(starts[g + 1] - sa, block));
  const int cb = max(0, min(starts[nbounds + g + 1] - sb, block - ca));
  const int cnt = ca + cb;
  const int a_at = table[p] + sa, b_at = table[p] + table[npairs + p] + sb;
  stage(key, block, in, total, in, total, a_at, ca, b_at, cb, n_cmp);
  if (in_idx != nullptr)
    stage(idx, block, in_idx, 0, in_idx, 0, a_at, ca, b_at, cb, 1);
  else
    for (int q = tid; q < cnt; q += T)
      idx[q] = q < ca ? a_at + q : b_at + (q - ca);
  cp_async_commit();
  cp_async_wait<0>();
  if (codes != 0)
    for (int q = tid; q < cnt; q += T)
      for (int l = 0; l < n_cmp; ++l)
        key[l * block + q] = order_bits(key[l * block + q], (codes >> (2 * l)) & 3);
  __syncthreads();

  const int E = block / T;
  const int d = tid * E;
  if (d < cnt) {
    int i = tile_corank<NC>(key, block, n_cmp, 0, ca, ca, cb, d);
    int jb = d - i;
    for (int e = 0; e < E && d + e < cnt; ++e) {
      bool take_b =
          jb < cb && (i >= ca || tile_less<NC>(key, block, n_cmp, ca + jb, i));
      src[d + e] = take_b ? ca + jb++ : i++;
    }
  }
  __syncthreads();

  const int o0 = table[p] + kk * block;
  for (int o = tid; o < cnt; o += T) {
    const int q = src[o];
    if (rank != nullptr) {
      rank[idx[q]] = o0 + o;
    } else {
      for (int l = 0; l < n_cmp; ++l)
        out[(size_t)l * total + o0 + o] = key[l * block + q];
      out[(size_t)n_cmp * total + o0 + o] = idx[q];
    }
  }
}

// cursors (n_runs, nblocks + 1) from the merge's inverse permutation `rank`
// and the runs' bases (n_runs + 1, the last one total)
__global__ void __launch_bounds__(CURSOR_THREADS)
kway_cursor_kernel(const int* __restrict__ rank, const int* __restrict__ bases,
                   int* cursors, int n_runs, int total, int nblocks,
                   int block) {
  extern __shared__ int base[];  // n_runs + 1
  for (int r = threadIdx.x; r <= n_runs; r += blockDim.x) base[r] = bases[r];
  __syncthreads();
  const long long n = (long long)total + n_runs;
  const size_t width = (size_t)nblocks + 1;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    if (t < total) {
      const int i = (int)t, r = last_at_most(base, n_runs, i);
      const int lo = i > base[r] ? rank[i - 1] / block + 1 : 0;
      const int hi = rank[i] / block;
      for (int jb = lo; jb <= hi; ++jb) cursors[r * width + jb] = i;
    } else {
      const int r = (int)(t - total), end = base[r + 1];
      const int lo = end > base[r] ? rank[end - 1] / block + 1 : 0;
      for (int jb = lo; jb <= nblocks; ++jb) cursors[r * width + jb] = end;
    }
  }
}

// --- the gather ---------------------------------------------------------------

// Lane l of every run, concatenated, into row l of `out` (n_lanes, total):
// run r's lane l is the 32-bit words ptrs[r * n_lanes + l][m * strides[r *
// n_lanes + l]], m < bases[r + 1] - bases[r].
__global__ void __launch_bounds__(GATHER_THREADS)
kway_gather_kernel(const long long* __restrict__ ptrs,
                   const int* __restrict__ strides,
                   const int* __restrict__ bases, uint32_t* out, int n_lanes,
                   int n_runs, int total) {
  extern __shared__ int base[];  // n_runs + 1
  for (int r = threadIdx.x; r <= n_runs; r += blockDim.x) base[r] = bases[r];
  __syncthreads();
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < total; p += (long long)gridDim.x * blockDim.x) {
    const int r = last_at_most(base, n_runs, p);
    const size_t m = (size_t)(p - base[r]);
    for (int l = 0; l < n_lanes; ++l) {
      const uint32_t* lane = (const uint32_t*)ptrs[(size_t)r * n_lanes + l];
      out[(size_t)l * total + p] = lane[m * strides[(size_t)r * n_lanes + l]];
    }
  }
}

// --- C entry points -------------------------------------------------------------

template <int NC>
static cudaError_t kway_launch(const uint32_t* cmp, const uint32_t* data,
                               uint32_t* out, const int* cursors, int n_cmp,
                               int n_arr, uint32_t codes, int total, int n_runs,
                               int nblocks, int block, int group, size_t smem,
                               cudaStream_t stream) {
  cudaError_t err = allow_smem(kway_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  const int threads = block / 2 < 1024 ? block / 2 : 1024;
  kway_kernel<NC><<<nblocks, threads, smem, stream>>>(
      cmp, data, out, cursors, n_cmp, n_arr, codes, total, n_runs, nblocks,
      block, group);
  return cudaGetLastError();
}

// Merge the k sorted runs concatenated in `cmp` (n_cmp, total) and `data`
// (n_arr, total) — stacked int32 lanes, `cmp` the compare lanes (the same
// memory as data when they lead the tuple) — into `out` (n_arr, total).
// `cursors` (n_runs, nblocks + 1): run r's segment for output block j
// starts at cursors[r][j] of the concatenation and ends at cursors[r][j+1].
// `codes` holds the compare lanes' codes.
extern "C" int kway_merge_lex(const void* cmp, const void* data, void* out,
                              const void* cursors, int n_cmp, int n_arr,
                              unsigned codes, int total, int n_runs,
                              int nblocks, int block, void* stream) {
  if (nblocks == 0) return cudaSuccess;
  if (block < 64 || (block & (block - 1)) || n_cmp < 1 || n_cmp > 15 ||
      n_arr < 1 || n_runs < 1 || n_runs > MAX_RUNS ||
      (long long)nblocks * block < total)
    return cudaErrorInvalidValue;
  // data lanes a pass: all that fit beside the keys, the two lane-0 key and
  // position buffers, the slots' runs and the scan
  const long long fixed = (long long)(n_cmp + 5) * block + 2LL * n_runs + 33;
  const long long room = (SMEM_LIMIT / 4 - fixed) / block;
  if (room < 1) return cudaErrorInvalidValue;
  const int group = n_arr < room ? n_arr : (int)room;
  const size_t smem = (size_t)(fixed + (long long)group * block) * sizeof(uint32_t);
  const uint32_t *c = (const uint32_t*)cmp, *d = (const uint32_t*)data;
  uint32_t* o = (uint32_t*)out;
  const int* cur = (const int*)cursors;
  cudaStream_t st = (cudaStream_t)stream;
#define KWAY_CASE(NC)                                                        \
  case NC:                                                                   \
    return kway_launch<NC>(c, d, o, cur, n_cmp, n_arr, codes, total, n_runs, \
                           nblocks, block, group, smem, st);
  switch (n_cmp) {
    KWAY_CASE(1) KWAY_CASE(2) KWAY_CASE(3) KWAY_CASE(4) KWAY_CASE(5)
    KWAY_CASE(6) KWAY_CASE(7) KWAY_CASE(8) KWAY_CASE(9)
    default:
      return kway_launch<0>(c, d, o, cur, n_cmp, n_arr, codes, total, n_runs,
                            nblocks, block, group, smem, st);
  }
#undef KWAY_CASE
}

template <int NC>
static cudaError_t round_launch(const uint32_t* in, const uint32_t* in_idx,
                                uint32_t* out, int* rank, int* starts,
                                const int* table, int npairs, int nbounds,
                                int nblocks_round, int n_cmp, uint32_t codes,
                                int total, int block, cudaStream_t stream) {
  const int per = SPLIT_THREADS / 32;
  kway_split_kernel<NC><<<(nbounds + per - 1) / per, SPLIT_THREADS, 0, stream>>>(
      in, starts, table, npairs, nbounds, n_cmp, codes, total, block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblocks_round == 0) return err;
  const size_t smem = (size_t)(n_cmp + 2) * block * sizeof(uint32_t);
  err = allow_smem(kway_round_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  const int threads = block / ROUND_E < 1024 ? block / ROUND_E : 1024;
  kway_round_kernel<NC><<<nblocks_round, threads, smem, stream>>>(
      in, in_idx, out, rank, starts, table, npairs, nbounds, n_cmp, codes,
      total, block);
  return cudaGetLastError();
}

// One round of the k-way split: the split and the merge of the round's
// `npairs` pairs (`table`, as above, with `nblocks_round` output blocks of
// `block` in all) of the stack `in` (n_cmp lanes of stride `total`, and
// `in_idx` its index lane or null in the first round) into `out` (n_cmp + 1
// lanes), `starts` scratch of 2 x (nblocks_round + npairs) ints. The last
// round passes `rank` (total ints) in place of `out`, and then the cursor
// matrix (n_runs, nblocks + 1) of the merge's `cursor_block`-slot output
// blocks is written to `cursors` from the runs' `bases` (n_runs + 1).
// `codes`: the compare lanes' codes in the first round, 0 (order keys)
// after it.
extern "C" int kway_split_round(const void* in, const void* in_idx, void* out,
                                void* rank, void* starts, const void* table,
                                int npairs, int nblocks_round, int n_cmp,
                                unsigned codes, int total, int block,
                                const void* bases, void* cursors, int n_runs,
                                int nblocks, int cursor_block, void* stream) {
  if (block < 2 * ROUND_E || (block & (block - 1)) || n_cmp < 1 ||
      n_cmp > 15 || npairs < 1 || nblocks_round < 0 ||
      (rank == nullptr) == (out == nullptr) ||
      (rank != nullptr && (cursors == nullptr || n_runs < 1 ||
                           n_runs > MAX_RUNS || cursor_block < 1)))
    return cudaErrorInvalidValue;
  const uint32_t *i = (const uint32_t*)in, *ix = (const uint32_t*)in_idx;
  uint32_t* o = (uint32_t*)out;
  int *rk = (int*)rank, *s = (int*)starts;
  const int* tb = (const int*)table;
  const int nbounds = nblocks_round + npairs;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define ROUND_CASE(NC)                                                        \
  case NC:                                                                    \
    err = round_launch<NC>(i, ix, o, rk, s, tb, npairs, nbounds,              \
                           nblocks_round, n_cmp, codes, total, block, st);    \
    break;
  switch (n_cmp) {
    ROUND_CASE(1) ROUND_CASE(2) ROUND_CASE(3) ROUND_CASE(4) ROUND_CASE(5)
    ROUND_CASE(6) ROUND_CASE(7) ROUND_CASE(8) ROUND_CASE(9)
    default:
      err = round_launch<0>(i, ix, o, rk, s, tb, npairs, nbounds,
                            nblocks_round, n_cmp, codes, total, block, st);
  }
#undef ROUND_CASE
  if (err != cudaSuccess || rank == nullptr) return err;
  const long long n = (long long)total + n_runs;
  long long grid = (n + CURSOR_THREADS - 1) / CURSOR_THREADS;
  if (grid > 4096) grid = 4096;
  kway_cursor_kernel<<<(int)grid, CURSOR_THREADS,
                       (n_runs + 1) * sizeof(int), st>>>(
      rk, (const int*)bases, (int*)cursors, n_runs, total, nblocks,
      cursor_block);
  return cudaGetLastError();
}

// Concatenate lane l of every run into row l of `out` (n_lanes, total):
// `ptrs` (n_runs x n_lanes int64 addresses of 32-bit lanes), `strides`
// (n_runs x n_lanes int32, in elements), `bases` (n_runs + 1 int32).
extern "C" int kway_gather_lanes(const void* ptrs, const void* strides,
                                 const void* bases, void* out, int n_lanes,
                                 int n_runs, int total, void* stream) {
  if (n_lanes < 1 || n_runs < 1 || n_runs > MAX_RUNS || total < 0)
    return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  long long grid = ((long long)total + GATHER_THREADS - 1) / GATHER_THREADS;
  if (grid > 4096) grid = 4096;
  kway_gather_kernel<<<(int)grid, GATHER_THREADS, (n_runs + 1) * sizeof(int),
                       (cudaStream_t)stream>>>(
      (const long long*)ptrs, (const int*)strides, (const int*)bases,
      (uint32_t*)out, n_lanes, n_runs, total);
  return cudaGetLastError();
}
