// Shared helpers for the port's CUDA kernels. Each kernel source is built
// by nvcc into its own shared library with a plain C interface
// (babble_tpu_torch/tpu/_ext.py loads them with ctypes). Every entry point
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BABBLE_MAX_INT32 2147483647
#define BABBLE_MIN_INT32 (-2147483647 - 1)
#define BABBLE_FULL_MASK 0xffffffffu

// One definition per shared library: each source includes this header once
// and each library is loaded on its own (RTLD_LOCAL).
extern "C" const char* babble_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned babble_blocks(long long work, int threads) {
    return static_cast<unsigned>((work + threads - 1) / threads);
}

// Block count for a grid-stride loop: enough blocks to fill every SM of
// an H100 (132) several times over, never more than the work needs.
static inline unsigned babble_stride_blocks(long long work, int threads) {
    unsigned b = babble_blocks(work, threads);
    return b < 132u * 32u ? b : 132u * 32u;
}

// Return the launch error, if any, from the enclosing entry point.
#define BABBLE_CHECK_LAUNCH()                                   \
    do {                                                        \
        cudaError_t babble_err_ = cudaGetLastError();           \
        if (babble_err_ != cudaSuccess) return (int)babble_err_; \
    } while (0)

#define BABBLE_CHECK(call)                                      \
    do {                                                        \
        cudaError_t babble_err_ = (call);                       \
        if (babble_err_ != cudaSuccess) return (int)babble_err_; \
    } while (0)

__device__ __forceinline__ int babble_clamp(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// *last_level = the last row of an (l_lv, n_lvl) level table that holds an
// event (>= 0), left as it is when none does (the caller sets -1 first).
// Rows past it are all padding. Grid-stride, one atomic per warp.
__global__ void babble_last_level(const int32_t* __restrict__ levels,
                                  int32_t* last_level, long long total, int n_lvl) {
    long long stride = (long long)gridDim.x * blockDim.x;
    int best = -1;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        if (levels[k] >= 0) best = max(best, (int)(k / n_lvl));
    }
    best = __reduce_max_sync(BABBLE_FULL_MASK, best);
    if ((threadIdx.x & 31) == 0 && best >= 0) atomicMax(last_level, best);
}
