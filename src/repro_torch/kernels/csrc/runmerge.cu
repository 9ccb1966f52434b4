// B5: merge-path combine of two sorted runs, one output block per CTA.
//
// Replaces repro/kernels/runmerge_kernel.py:54 (_runmerge_kernel): there each
// grid step DMAs the a- and b-segments of one output block into VMEM at
// scalar-prefetched starts, masks the tails to the sentinel tuple, runs the
// asc ++ asc merge network (merge_kernel._merge_network) on the 2B window
// with every lane of the tuple in it, and keeps the low half.
//
// Here one CTA makes one output block k. The diagonal split comes in from
// the wrapper (`starts`, merge-path ranks of a computed in torch): a[sa, ea)
// and b[sb, eb) hold exactly the elements of output slots [kB, kB + B).
// The window in shared memory carries only the n_cmp compare lanes and one
// int32 source-index lane (a's element i is i, b's element i is na + i); the
// tails fill with the sentinel tuple and the index 0x7FFFFFFF, above every
// real index. B4's network (merge_halves) merges the window; then each of
// the low B slots copies every data lane from its source index in global
// memory. The compare prefix is an order-preserving refinement of the tuple
// (equal prefix, equal tuple), and the index breaks the remaining ties a
// before b and in run order, so the window's order is unique: the result is
// the stable merge, bit for bit that of keypack.merge_take_packed, on any
// lanes, float ties included. Shared memory is (n_cmp + 1) x 2B x 4 B — 12 KB
// at the pipeline's 5 compare lanes and B = 256 — whatever the data width,
// so the 10-array shortlex tuple of 15-byte words and the 18-array one of
// 32-byte words take the same window.
//
// What bounds it on the H100: every data lane is read once and written once,
// so the least time is those bytes over 3.35 TB/s; the network's
// (log2(B) + 1) x B compares per block stay below the compute peak. One CTA
// per 256 outputs with a barrier per network step, and gathers of the data
// lanes by index; staging with TMA and a register network are later work.
#include "common.cuh"

#define INDEX_FILL 0x7FFFFFFFu

__global__ void runmerge_kernel(const uint32_t* cmp_a, const uint32_t* cmp_b,
                                const uint32_t* data_a, const uint32_t* data_b,
                                uint32_t* out, const int* starts, int n_cmp,
                                int n_arr, uint32_t codes, int na, int nb,
                                int nblocks, int block) {
  extern __shared__ uint32_t smem[];
  int width = 2 * block;
  Window w{smem, width, n_cmp + 1, codes};
  uint32_t* idx = smem + (size_t)n_cmp * width;
  int k = blockIdx.x;
  int sa = starts[k], ca = starts[k + 1] - sa;
  int sb = starts[nblocks + 1 + k], cb = starts[nblocks + 2 + k] - sb;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    for (int l = 0; l < n_cmp; ++l) {
      uint32_t fill = sentinel_bits((codes >> (2 * l)) & 3);
      smem[l * width + i] = i < ca ? cmp_a[(size_t)l * na + sa + i] : fill;
      smem[l * width + block + i] =
          i < cb ? cmp_b[(size_t)l * nb + sb + i] : fill;
    }
    idx[i] = i < ca ? (uint32_t)(sa + i) : INDEX_FILL;
    idx[block + i] = i < cb ? (uint32_t)(na + sb + i) : INDEX_FILL;
  }
  __syncthreads();
  merge_halves(w, block);
  long long total = (long long)na + nb;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    long long o = (long long)k * block + i;
    if (o >= total) continue;
    int src = (int)idx[i];
    for (int l = 0; l < n_arr; ++l)
      out[l * total + o] = src < na ? data_a[(size_t)l * na + src]
                                    : data_b[(size_t)l * nb + (src - na)];
  }
}

// Merge the sorted runs a and b, stacked (arrays, n) int32 lanes: `cmp_*`
// (n_cmp, n) the compare lanes, `data_*` (n_arr, n) the lanes to merge (the
// same memory as cmp_* when the compare lanes lead the tuple), `out`
// (n_arr, na + nb), `starts` (2, nblocks + 1) the diagonal split. `codes`
// holds the compare lanes' codes and, at position n_cmp, the index lane's.
extern "C" int runmerge_lex(const void* cmp_a, const void* cmp_b,
                            const void* data_a, const void* data_b, void* out,
                            const void* starts, int n_cmp, int n_arr,
                            unsigned codes, int na, int nb, int nblocks,
                            int block, void* stream) {
  if (nblocks == 0) return cudaSuccess;
  if (block < 1 || (block & (block - 1)) || n_cmp < 1 || n_cmp > 15 ||
      (long long)nblocks * block < (long long)na + nb)
    return cudaErrorInvalidValue;
  size_t smem = (size_t)(n_cmp + 1) * 2 * block * sizeof(uint32_t);
  cudaError_t err = allow_smem(runmerge_kernel, smem);
  if (err != cudaSuccess) return err;
  runmerge_kernel<<<nblocks, threads_for(block), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)cmp_a, (const uint32_t*)cmp_b, (const uint32_t*)data_a,
      (const uint32_t*)data_b, (uint32_t*)out, (const int*)starts, n_cmp,
      n_arr, codes, na, nb, nblocks, block);
  return cudaGetLastError();
}
