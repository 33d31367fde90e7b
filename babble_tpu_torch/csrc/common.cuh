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

// Whether one event strongly sees a supermajority of a round's witnesses,
// decided by a whole warp:
//   |{w < n : present(w) and |{q < n : la_e[q] >= fd_rows[w * n + q]}| >= sm}| >= sm,
// the same on every lane. la_e (n,) lies in shared memory; present(w)
// reads the caller's validity table. Lanes run over q (coalesced rows)
// and count with ballots; BABBLE_WG witnesses' loads are issued before
// their ballots. The walk stops once the verdict is known (sm witnesses
// seen, or too few left to reach sm): the callers need the verdict only.
// A coordinate past n or an absent witness compares against MAX_INT32,
// which no real lastAncestors entry reaches.
#define BABBLE_WG 8
template <typename Present>
__device__ __forceinline__ bool babble_warp_sees_majority(const int32_t* la_e,
                                                          const int32_t* fd_rows, int n,
                                                          int super_majority, Present present) {
    const int lane = threadIdx.x & 31;
    int seen = 0;  // warp-uniform
    for (int w0 = 0; w0 < n; w0 += BABBLE_WG) {
        if (seen >= super_majority || seen + (n - w0) < super_majority) break;
        int cnt[BABBLE_WG];
        bool ok[BABBLE_WG];
#pragma unroll
        for (int u = 0; u < BABBLE_WG; ++u) {
            cnt[u] = 0;
            ok[u] = w0 + u < n && present(w0 + u);
        }
        for (int q0 = 0; q0 < n; q0 += 32) {
            const int q = q0 + lane;
            const int la_q = q < n ? la_e[q] : 0;
            int v[BABBLE_WG];
#pragma unroll
            for (int u = 0; u < BABBLE_WG; ++u) {
                v[u] = (ok[u] && q < n) ? fd_rows[(long long)(w0 + u) * n + q]
                                        : BABBLE_MAX_INT32;
            }
#pragma unroll
            for (int u = 0; u < BABBLE_WG; ++u) {
                cnt[u] += __popc(__ballot_sync(BABBLE_FULL_MASK, la_q >= v[u]));
            }
        }
#pragma unroll
        for (int u = 0; u < BABBLE_WG; ++u) seen += ok[u] && cnt[u] >= super_majority;
    }
    return seen >= super_majority;
}
