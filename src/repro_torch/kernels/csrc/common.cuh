// Shared pieces of the port's kernels: the lane codes, the canonical order
// bits of kernels/lex.py, the lexicographic compare and the load/store of
// one window of a stacked (arrays, rows, cols) lane tensor (B1's wide rows).
// B2 and B4 run their networks from registers (network.cuh); B5 and B6 merge
// (merge_path.cuh).
//
// Every kernel reads each lane's raw 32 bits and its code, compares the
// order bits computed in registers, and swaps the raw bits: an output is a
// bit-level permutation of its input, every NaN sorts above +inf, -0.0 ==
// +0.0, and the all-ones float (the padding sentinel) sorts strictly highest.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_ARRAYS 9
// the dynamic shared memory a Hopper block may opt in to (227 KB)
#define SMEM_LIMIT 232448

enum { CODE_U32 = 0, CODE_I32 = 1, CODE_F32 = 2 };

__device__ __forceinline__ uint32_t order_bits(uint32_t b, int code) {
  if (code == CODE_U32) return b;
  if (code == CODE_I32) return b ^ 0x80000000u;
  uint32_t mag = b & 0x7FFFFFFFu;
  if (mag > 0x7F800000u) return b == 0xFFFFFFFFu ? 0xFFFFFFFFu : 0xFFFFFFFEu;
  if (mag == 0) b = 0;  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The lex-maximal padding bits of a code: the positive max for int32, all
// ones (the uint32 max, the float32 padding NaN) otherwise.
__device__ __forceinline__ uint32_t sentinel_bits(int code) {
  return code == CODE_I32 ? 0x7FFFFFFFu : 0xFFFFFFFFu;
}

// The window of one row in shared memory: array a's element i at
// s[a * width + i].
struct Window {
  uint32_t* s;
  int width;
  int n_arr;
  uint32_t codes;  // two bits per array, array 0 lowest

  // lexicographic s[i] > s[j] over all arrays, array 0 most significant
  __device__ __forceinline__ bool gt(int i, int j) const {
    for (int a = 0; a < n_arr; ++a) {
      int code = (codes >> (2 * a)) & 3;
      uint32_t x = order_bits(s[a * width + i], code);
      uint32_t y = order_bits(s[a * width + j], code);
      if (x != y) return x > y;
    }
    return false;
  }

  __device__ __forceinline__ void swap(int i, int j) const {
    for (int a = 0; a < n_arr; ++a) {
      uint32_t t = s[a * width + i];
      s[a * width + i] = s[a * width + j];
      s[a * width + j] = t;
    }
  }

  // compare-exchange: the smaller tuple to i (i < j); ties never move
  __device__ __forceinline__ void cmpx(int i, int j) const {
    if (gt(i, j)) swap(i, j);
  }

  // copy `width` columns of one row from global memory (lane stride
  // `lane_stride`, row start `row`) into the window, every thread helping
  __device__ __forceinline__ void load(const uint32_t* x, size_t lane_stride,
                                       size_t row) const {
    for (int a = 0; a < n_arr; ++a)
      for (int i = threadIdx.x; i < width; i += blockDim.x)
        s[a * width + i] = x[a * lane_stride + row + i];
  }

  __device__ __forceinline__ void store(uint32_t* x, size_t lane_stride,
                                        size_t row) const {
    for (int a = 0; a < n_arr; ++a)
      for (int i = threadIdx.x; i < width; i += blockDim.x)
        x[a * lane_stride + row + i] = s[a * width + i];
  }
};

// Threads for a block that works on `pairs` compare-exchanges per step:
// whole warps, at most 1024.
static inline int threads_for(long long pairs) {
  long long t = (pairs + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return (int)t;
}

// Allow `bytes` of dynamic shared memory for `kernel`; an error if over the cap.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
