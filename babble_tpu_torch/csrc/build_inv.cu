// build_inv: the frontier walk's threshold tables.
//
// Replaces babble_tpu/tpu/frontier.py:116 build_inv (a JAX scatter-min
// into value slots, then a log-step suffix_min over the value axis).
//
//   INV[c, p, v] = first chain-c index i whose p-coordinate
//                  min(la[rows_by[c, i], p], L-1) >= v,  L = "never";
//   padded chain slots (rows_by < 0) and absent coordinates (la < 0)
//   contribute nothing (the reference's dropped slot v = L).
//
// Bound: bytes. The function reads rows_by and la once and writes INV
// (N_c * N_p * L int32) once: at 64 validators and L = 1024 that is about
// 34 MB, about 10 us at 3.35 TB/s. Design: three passes, each coalesced.
// (1) fill INV with L; (2) one thread per (c, i, p), neighbouring threads
// on neighbouring p of one la row, atomicMin of i into slot v; (3) one warp
// per (c, p) row, a suffix minimum over v in 32-wide chunks from the top,
// carrying the running minimum from chunk to chunk. Integer atomics are
// order-independent, so the result is exact and deterministic.

#include "common.cuh"

__global__ void inv_fill(int32_t* inv, long long total, int l) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        inv[k] = l;
    }
}

__global__ void inv_scatter(const int32_t* __restrict__ rows_by,
                            const int32_t* __restrict__ la,
                            int32_t* inv, int n_c, int l, int n_p, int e) {
    long long total = (long long)n_c * l * n_p;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        int p = (int)(k % n_p);
        long long ci = k / n_p;
        int i = (int)(ci % l);
        int c = (int)(ci / l);
        int row = rows_by[(long long)c * l + i];
        if (row < 0) continue;
        row = min(row, e - 1);  // the reference's gather clamps
        int a = la[(long long)row * n_p + p];
        if (a < 0) continue;
        int v = min(a, l - 1);
        atomicMin(&inv[((long long)c * n_p + p) * l + v], i);
    }
}

__global__ void inv_suffix_min(int32_t* inv, long long rows, int l) {
    long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (warp >= rows) return;  // uniform across the warp
    int32_t* row = inv + warp * l;
    int carry = l;
    for (int base = ((l - 1) / 32) * 32; base >= 0; base -= 32) {
        int v = base + lane;
        int x = v < l ? row[v] : l;
        for (int off = 1; off < 32; off <<= 1) {
            int y = __shfl_down_sync(BABBLE_FULL_MASK, x, off);
            if (lane + off < 32) x = min(x, y);
        }
        x = min(x, carry);
        if (v < l) row[v] = x;
        carry = __shfl_sync(BABBLE_FULL_MASK, x, 0);
    }
}

extern "C" int babble_build_inv(const int32_t* rows_by, const int32_t* la,
                                int32_t* inv, int n_c, int l, int n_p, int e,
                                int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    long long cells = (long long)n_c * n_p * l;
    inv_fill<<<babble_stride_blocks(cells, threads), threads, 0, s>>>(inv, cells, l);
    BABBLE_CHECK_LAUNCH();
    if (e > 0) {
        inv_scatter<<<babble_stride_blocks(cells, threads), threads, 0, s>>>(
            rows_by, la, inv, n_c, l, n_p, e);
        BABBLE_CHECK_LAUNCH();
    }
    long long rows = (long long)n_c * n_p;
    inv_suffix_min<<<babble_blocks(rows * 32, threads), threads, 0, s>>>(inv, rows, l);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
