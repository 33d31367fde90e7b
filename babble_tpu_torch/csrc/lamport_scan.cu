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
// Exactly as the reference: each level reads the carry as it stood before
// any write of that level, so a parent in the same level or a later one
// reads the initial 0; parent indices clamp to E - 1 and a parent outside
// the grid (index < 0) takes its external value; max + 1 wraps around as an
// int32 add; a pin wins; padding lanes write nothing; the walk stops after
// the last level that holds an event.
//
// Bound: the chain of dependent levels. The function reads each event's
// parents and seeds once and writes (E,) int32 (well under a microsecond of
// bytes at 3.35 TB/s), but every level reads what the previous one wrote,
// so a level costs its chain of dependent reads. Design: common.cuh's
// staged level walk (babble_lamport_walk). A prep launch packs every cell
// of the level table into one 16-byte record {row, s, o, x}
// (babble_lamport_record: the parents clamped to E - 1 or -1, the external
// values and the pin folded into x), sets the carry's device rows to 0 and
// finds the last level that holds an event. One block walks the levels: a
// producer warp bulk-copies the records into a ring in shared memory ahead
// of the consumer warps (a thread per lane), whose carry lies in shared
// memory for its first `chip` rows (tpu/_ext.py level_walk_plan: as many as
// fit beside the ring) and in device memory past them; a level is then a
// record read, two carry reads, a max and two syncs (__syncwarp up to 32
// lanes, a named barrier over the consumer warps above). A level too wide
// for the ring is read in place in device memory.
//
// Launches per call: two (prep, walk; a memset sets the last level to -1
// before them).

#include "common.cuh"

// The records of every cell, the carry's initial 0 in every row, and
// *last_level (-1 on entry) to the last level that holds an event.
__global__ void lam_prep(const int32_t* __restrict__ levels, const int32_t* __restrict__ sp,
                         const int32_t* __restrict__ op, const int32_t* __restrict__ esp,
                         const int32_t* __restrict__ eop, const int32_t* __restrict__ fpin,
                         int32_t* lam, int32_t* last_level, int4* table, long long cells,
                         int n_lvl, int e) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long k0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long k = k0; k < e; k += stride) lam[k] = 0;
    int best = -1;
    for (long long k = k0; k < cells; k += stride) {
        const int row = levels[k];
        table[k] = babble_lamport_record(row, sp, op, esp, eop, fpin, e);
        if (row >= 0) best = max(best, (int)(k / n_lvl));
    }
    best = __reduce_max_sync(BABBLE_FULL_MASK, best);
    if ((threadIdx.x & 31) == 0 && best >= 0) atomicMax(last_level, best);
}

template <bool ONE>
__global__ void __launch_bounds__(1024) lam_staged(BabbleLamWalk a) {
    extern __shared__ int4 lam_staged_smem[];
    babble_lamport_walk<ONE>(a, reinterpret_cast<unsigned char*>(lam_staged_smem));
}

extern "C" int babble_lamport_scan(
    const int32_t* levels, const int32_t* sp, const int32_t* op,
    const int32_t* esp, const int32_t* eop, const int32_t* fpin,
    int32_t* lam, int32_t* last_level, int32_t* table, int l_lv, int n_lvl, int e,
    int warps, int chunk, int stages, int staged, int chip, int threads,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    BABBLE_CHECK(cudaMemsetAsync(last_level, 0xff, sizeof(int32_t), s));
    const long long cells = (long long)l_lv * n_lvl;
    const long long work = cells > e ? cells : e;
    lam_prep<<<babble_stride_blocks(work > 0 ? work : 1, 256), 256, 0, s>>>(
        levels, sp, op, esp, eop, fpin, lam, last_level, reinterpret_cast<int4*>(table), cells,
        n_lvl, e);
    BABBLE_CHECK_LAUNCH();
    const BabbleLamWalk a{last_level, table, lam, n_lvl, 0, warps, chunk, stages, staged, chip};
    const long long smem = babble_lamport_walk_bytes(a);
    if (smem > 232448 || threads > 1024 || threads < 32 * (1 + warps)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_lvl <= 32 * warps) {
        BABBLE_CHECK(babble_allow_smem(lam_staged<true>, (size_t)smem));
        lam_staged<true><<<1, threads, (size_t)smem, s>>>(a);
    } else {
        BABBLE_CHECK(babble_allow_smem(lam_staged<false>, (size_t)smem));
        lam_staged<false><<<1, threads, (size_t)smem, s>>>(a);
    }
    BABBLE_CHECK_LAUNCH();
    return 0;
}
