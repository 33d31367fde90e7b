// divide_rounds: the level-scan DivideRounds.
//
// Replaces babble_tpu/tpu/kernels.py:118 _divide_rounds (a lax.scan over
// the (L, N) topological level table). Per level, for each lane's event e
// (a row of the level, -1 = padding):
//   parent_round = max(round(self-parent), round(other-parent)), a parent
//                  outside the grid taking ext_sp_round / ext_op_round;
//   c_seen       = |{w : wtable[parent_round, w] is a witness and
//                        |{p : la[e, p] >= fd[w, p]}| >= super_majority}|;
//   round        = parent_round + (c_seen >= super_majority), unless
//                  fixed_round >= 0 forces it;
//   witness      = round > round(self-parent);
//   lamport      = max(lamport(sp), lamport(op)) + 1, unless fixed_lamport
//                  != MIN forces it (external parents: ext_*_lamport);
// and a witness writes its row into wtable[clip(round, 0, r_max-1), creator].
//
// Bound: the chain of dependent levels, not bytes or operations. The
// function reads each event's metadata and la row once, the witnesses' fd
// rows, and writes the (E,) outputs and the (r_max, N) table: a few MB,
// about a microsecond at 3.35 TB/s. But level k+1 reads what level k wrote,
// so the levels run in order. Design: one thread block walks every level
// (a launch per level would mean 10,180 launches on a deep section).
// Inside a level, one warp per lane: the warp caches la[e] and the parent
// round's witness-table row in shared memory. Up to 32 validators each
// lane takes one witness and reads its fd row with independent loads, so
// one L2 round trip serves the whole count, and a warp sum gives c_seen;
// above 32, the fd row of each witness in turn is read coalesced (lanes
// over p) and summed across the warp, where reading N rows with lanes over
// rows would touch 32 cache lines per load. A barrier separates the read phase of a level from
// its write phase (the reference reads the whole carry before it scatters,
// so no lane may see another lane's write of the same level), and a second
// barrier makes the writes visible to the next level. Padding lanes write
// nothing (the reference's dropped scatter); the walk stops after the last
// level that holds an event, since padding rows change nothing.
//
// The packed layout (babble_tpu/tpu/kernels.py:147-153, packed=True)
// counts the same compares with packed_count and c_seen as the popcount of
// the strongly-seen words: the same integers as these counts, so the
// wrapper launches this kernel for both layouts (counted apart).
//
// The block's per-lane values and per-warp rows take (3 n_lvl + 64 n) x 4
// bytes: past one block's shared memory (about 900 validators) they live
// in a device scratch instead (common.cuh babble_staging), the same code.
//
// Launches per call: three (init, last level, walk).

#include "common.cuh"

#define DR_MAX_WARPS 32

// outputs to their initial values; *last_level = -1
__global__ void dr_init(int32_t* rounds, int32_t* lamport, uint8_t* witness,
                        int32_t* wtable, int32_t* last_level, int e,
                        long long wt_total) {
    long long stride = (long long)gridDim.x * blockDim.x;
    long long k0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k0 == 0) *last_level = -1;
    for (long long k = k0; k < e; k += stride) {
        rounds[k] = -1;
        lamport[k] = -1;
        witness[k] = 0;
    }
    for (long long k = k0; k < wt_total; k += stride) wtable[k] = -1;
}

template <bool DEV>
__global__ void dr_walk(const int32_t* __restrict__ levels,
                        const int32_t* __restrict__ creator,
                        const int32_t* __restrict__ self_parent,
                        const int32_t* __restrict__ other_parent,
                        const int32_t* __restrict__ la,
                        const int32_t* __restrict__ fd,
                        const int32_t* __restrict__ ext_sp_round,
                        const int32_t* __restrict__ ext_op_round,
                        const int32_t* __restrict__ fixed_round,
                        const int32_t* __restrict__ ext_sp_lamport,
                        const int32_t* __restrict__ ext_op_lamport,
                        const int32_t* __restrict__ fixed_lamport,
                        const int32_t* __restrict__ last_level,
                        int32_t* rounds, uint8_t* witness, int32_t* lamport,
                        int32_t* wtable, int n_lvl, int e, int n,
                        int super_majority, int r_max, int32_t* stage) {
    int32_t* smem = babble_staging<DEV>(stage, 0);
    int32_t* s_round = smem;             // (n_lvl,) new round per lane
    int32_t* s_lt = s_round + n_lvl;     // (n_lvl,) new lamport
    int32_t* s_wit = s_lt + n_lvl;       // (n_lvl,) new witness flag
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int32_t* la_e = s_wit + n_lvl + warp * 2 * n;  // (n,) this warp's la row
    int32_t* wrow = la_e + n;                      // (n,) its witness-table row
    const int last = *last_level;

    for (int lv = 0; lv <= last; ++lv) {
        const int32_t* lrow = levels + (long long)lv * n_lvl;
        // read phase: every lane's new values from the carry as it stood
        for (int i = warp; i < n_lvl; i += n_warps) {
            const int row = lrow[i];
            if (row < 0) continue;  // padding lane (warp-uniform)
            const int sp = self_parent[row], op = other_parent[row];
            const int sp_round = sp >= 0 ? rounds[min(sp, e - 1)] : ext_sp_round[row];
            const int op_round = op >= 0 ? rounds[min(op, e - 1)] : ext_op_round[row];
            const int pr = max(sp_round, op_round);
            const int32_t* wt = wtable + (long long)babble_clamp(pr, 0, r_max - 1) * n;
            for (int p = lane; p < n; p += 32) {
                la_e[p] = la[(long long)row * n + p];
                wrow[p] = pr >= 0 ? wt[p] : -1;  // parent_round < 0: no witness
            }
            __syncwarp();
            int seen = 0;  // the same on every lane after the warp sums
            if (n <= 32) {
                const int wr = lane < n ? wrow[lane] : -1;
                if (wr >= 0) {
                    const int32_t* fd_w = fd + (long long)min(wr, e - 1) * n;
                    int cnt = 0;
                    for (int p = 0; p < n; ++p) cnt += la_e[p] >= fd_w[p];
                    seen = cnt >= super_majority;
                }
                seen = __reduce_add_sync(BABBLE_FULL_MASK, seen);
            } else {
                for (int w = 0; w < n; ++w) {
                    const int wr = wrow[w];
                    if (wr < 0) continue;  // warp-uniform
                    const int32_t* fd_w = fd + (long long)min(wr, e - 1) * n;
                    int cnt = 0;
                    for (int p = lane; p < n; p += 32) cnt += la_e[p] >= fd_w[p];
                    cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
                    seen += cnt >= super_majority;
                }
            }
            if (lane == 0) {
                int rd = pr + (seen >= super_majority ? 1 : 0);
                const int fixed = fixed_round[row];
                if (fixed >= 0) rd = fixed;
                const int sp_lt = sp >= 0 ? lamport[min(sp, e - 1)] : ext_sp_lamport[row];
                const int op_lt = op >= 0 ? lamport[min(op, e - 1)] : ext_op_lamport[row];
                // int32 wrap-around, as the reference's int32 add
                int lt = (int)((unsigned)max(sp_lt, op_lt) + 1u);
                const int fl = fixed_lamport[row];
                if (fl != BABBLE_MIN_INT32) lt = fl;
                s_round[i] = rd;
                s_lt[i] = lt;
                s_wit[i] = rd > sp_round;
            }
            __syncwarp();
        }
        __syncthreads();
        // write phase
        for (int i = threadIdx.x; i < n_lvl; i += blockDim.x) {
            const int row = lrow[i];
            if (row < 0) continue;
            const int rd = s_round[i];
            rounds[row] = rd;
            lamport[row] = s_lt[i];
            witness[row] = (uint8_t)s_wit[i];
            const int c = creator[row];
            if (s_wit[i] && c >= 0 && c < n) {
                wtable[(long long)babble_clamp(rd, 0, r_max - 1) * n + c] = row;
            }
        }
        __syncthreads();
    }
}

extern "C" int babble_divide_rounds(
    const int32_t* levels, const int32_t* creator, const int32_t* self_parent,
    const int32_t* other_parent, const int32_t* la, const int32_t* fd,
    const int32_t* ext_sp_round, const int32_t* ext_op_round,
    const int32_t* fixed_round, const int32_t* ext_sp_lamport,
    const int32_t* ext_op_lamport, const int32_t* fixed_lamport,
    int32_t* rounds, uint8_t* witness, int32_t* lamport, int32_t* wtable,
    int32_t* last_level, int32_t* stage,
    int l_lv, int n_lvl, int e, int n, int super_majority, int r_max,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long wt_total = (long long)r_max * n;
    long long work = wt_total > e ? wt_total : e;
    dr_init<<<babble_stride_blocks(work, 256), 256, 0, s>>>(
        rounds, lamport, witness, wtable, last_level, e, wt_total);
    BABBLE_CHECK_LAUNCH();
    long long lv_total = (long long)l_lv * n_lvl;
    if (lv_total > 0) {
        babble_last_level<<<babble_stride_blocks(lv_total, 256), 256, 0, s>>>(
            levels, last_level, lv_total, n_lvl);
        BABBLE_CHECK_LAUNCH();
    }
    int warps = n_lvl < DR_MAX_WARPS ? (n_lvl > 0 ? n_lvl : 1) : DR_MAX_WARPS;
    // the block's staging in `stage` where the wrapper hands it one
    // (tpu/_ext.py staging chooses the form), else in shared memory
    const size_t smem = ((size_t)3 * n_lvl + (size_t)warps * 2 * n) * sizeof(int32_t);
    if (stage != nullptr) {
        dr_walk<true><<<1, 32 * warps, 0, s>>>(
            levels, creator, self_parent, other_parent, la, fd, ext_sp_round,
            ext_op_round, fixed_round, ext_sp_lamport, ext_op_lamport,
            fixed_lamport, last_level, rounds, witness, lamport, wtable, n_lvl, e,
            n, super_majority, r_max, stage);
    } else {
        BABBLE_CHECK(babble_allow_smem(dr_walk<false>, smem));
        dr_walk<false><<<1, 32 * warps, smem, s>>>(
            levels, creator, self_parent, other_parent, la, fd, ext_sp_round,
            ext_op_round, fixed_round, ext_sp_lamport, ext_op_lamport,
            fixed_lamport, last_level, rounds, witness, lamport, wtable, n_lvl, e,
            n, super_majority, r_max, nullptr);
    }
    BABBLE_CHECK_LAUNCH();
    return 0;
}
