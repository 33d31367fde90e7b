// lamport_scan: the lamport recurrence over the level table, seeded.
//
// Replaces babble_tpu/tpu/doubling.py:443 _lamport_levels_scan (the lamport
// slice of the level scan, for post-reset sections). Per level, for each
// lane's event e (-1 = padding):
//   lamport(e) = max(lamport(sp), lamport(op)) + 1, a parent outside the
//                grid taking ext_sp_lamport / ext_op_lamport, unless
//                fixed_lamport(e) != MIN forces it.
// The carry starts at 0, not -1 as in the full level scan.
//
// Bound: the chain of dependent levels. The function reads each event's
// parents and seeds once and writes (E,) int32 (well under a microsecond of
// bytes at 3.35 TB/s), but every level reads what the previous one wrote.
// Design: one thread block walks every level, one thread per lane; a
// barrier between the read phase and the write phase of each level (the
// reference reads the whole carry before it scatters) and one after the
// writes. Padding lanes write nothing; the walk stops after the last level
// that holds an event.
//
// Launches per call: three (init, last level, walk).

#include "common.cuh"

__global__ void lam_init(int32_t* lam, int32_t* last_level, int e) {
    long long stride = (long long)gridDim.x * blockDim.x;
    long long k0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k0 == 0) *last_level = -1;
    for (long long k = k0; k < e; k += stride) lam[k] = 0;
}

__global__ void lam_walk(const int32_t* __restrict__ levels,
                         const int32_t* __restrict__ sp,
                         const int32_t* __restrict__ op,
                         const int32_t* __restrict__ esp,
                         const int32_t* __restrict__ eop,
                         const int32_t* __restrict__ fpin,
                         const int32_t* __restrict__ last_level,
                         int32_t* lam, int n_lvl, int e) {
    extern __shared__ int32_t vals[];  // (n_lvl,) new lamport per lane
    const int last = *last_level;
    for (int lv = 0; lv <= last; ++lv) {
        const int32_t* lrow = levels + (long long)lv * n_lvl;
        for (int i = threadIdx.x; i < n_lvl; i += blockDim.x) {
            const int row = lrow[i];
            if (row < 0) continue;
            const int s = sp[row], o = op[row];
            const int sl = s >= 0 ? lam[min(s, e - 1)] : esp[row];
            const int ol = o >= 0 ? lam[min(o, e - 1)] : eop[row];
            int v = (int)((unsigned)max(sl, ol) + 1u);
            const int pin = fpin[row];
            if (pin != BABBLE_MIN_INT32) v = pin;
            vals[i] = v;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < n_lvl; i += blockDim.x) {
            const int row = lrow[i];
            if (row >= 0) lam[row] = vals[i];
        }
        __syncthreads();
    }
}

extern "C" int babble_lamport_scan(
    const int32_t* levels, const int32_t* sp, const int32_t* op,
    const int32_t* esp, const int32_t* eop, const int32_t* fpin,
    int32_t* lam, int32_t* last_level, int l_lv, int n_lvl, int e,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    lam_init<<<babble_stride_blocks(e > 0 ? e : 1, 256), 256, 0, s>>>(lam, last_level, e);
    BABBLE_CHECK_LAUNCH();
    long long lv_total = (long long)l_lv * n_lvl;
    if (lv_total > 0) {
        babble_last_level<<<babble_stride_blocks(lv_total, 256), 256, 0, s>>>(
            levels, last_level, lv_total, n_lvl);
        BABBLE_CHECK_LAUNCH();
    }
    int threads = n_lvl < 1024 ? ((n_lvl + 31) / 32) * 32 : 1024;
    if (threads < 32) threads = 32;
    size_t smem = (size_t)(n_lvl > 0 ? n_lvl : 1) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            lam_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    }
    lam_walk<<<1, threads, smem, s>>>(
        levels, sp, op, esp, eop, fpin, last_level, lam, n_lvl, e);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
