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
// about a microsecond at 3.35 TB/s; its compares (lanes x witnesses x N per
// level) take a fraction of a millisecond at the ALU rate. But level k+1
// reads what level k wrote, so the levels run in order. Two forms, chosen
// by the wrapper (tpu/_ext.py divide_rounds_form: by width):
//
// dr_walk, narrow levels: one thread block walks every level (a launch per
// level would mean 10,180 launches on a deep section; a barrier across the
// grid costs more than such a level). One warp per lane: the warp caches
// la[e] and the parent round's witness-table row in shared memory. Up to
// 32 validators each lane takes one witness and reads its fd row with
// independent loads, so one L2 round trip serves the whole count, and a
// warp sum gives c_seen; above 32, the fd row of each witness in turn is
// read coalesced (lanes over p) and summed across the warp, and the walk
// stops once the verdict is known (only c_seen >= super_majority is used).
// A barrier separates the read phase of a level from its write phase (the
// reference reads the whole carry before it scatters, so no lane may see
// another lane's write of the same level), and a second barrier makes the
// writes visible to the next level.
//
// dr_grid, wider levels: a cooperative launch over as many blocks as the
// card holds at once (at most one per work item), two barriers across the
// grid per level:
//   (A) a work item is (8 lanes) x (32 witnesses) of the level; the block
//       takes the lanes' parent rounds from the rounds written at earlier
//       levels, and per distinct parent round among them counts the lanes'
//       la rows against the fd rows of that round's witnesses through the
//       compare-count tile (common.cuh babble_count_ge_tile: coordinates
//       through shared memory by cp.async, a register tile per thread), and
//       adds each lane's verdicts (count >= super_majority) into its c_seen
//       in global memory; a lane whose c_seen already reaches the
//       supermajority skips its remaining items. The item of witness tile 0
//       also records each lane's parent round, self-parent round and new
//       lamport number, read before any write of the level;
//   (B) after the barrier, each lane's round, witness flag and lamport
//       follow from those and c_seen, are written with the witness-table
//       scatter, and c_seen is reset; then the second barrier.
// Everything the walk writes and reads back (rounds, lamport, the witness
// table, the per-lane carries) goes through L2 (__ldcg / __stcg). Shared
// memory per block is the tile's ring, the same at every width.
//
// Padding lanes write nothing (the reference's dropped scatter); both forms
// stop after the last level that holds an event, since padding rows change
// nothing.
//
// The packed layout (babble_tpu/tpu/kernels.py:147-153, packed=True)
// counts the same compares with packed_count and c_seen as the popcount of
// the strongly-seen words: the same integers as these counts, so the
// wrapper launches this kernel for both layouts (counted apart).
//
// Launches per call: three (init, last level, walk).

#include "common.cuh"

#define DR_MAX_WARPS 32

// outputs to their initial values; *last_level = -1; the grid form's
// per-lane c_seen and barrier count (scratch, 4 n_lvl + 1 words) to 0
__global__ void dr_init(int32_t* rounds, int32_t* lamport, uint8_t* witness,
                        int32_t* wtable, int32_t* last_level, int32_t* scratch, int e,
                        long long wt_total, int n_lvl) {
    long long stride = (long long)gridDim.x * blockDim.x;
    long long k0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k0 == 0) *last_level = -1;
    for (long long k = k0; k < e; k += stride) {
        rounds[k] = -1;
        lamport[k] = -1;
        witness[k] = 0;
    }
    for (long long k = k0; k < wt_total; k += stride) wtable[k] = -1;
    if (scratch != nullptr) {
        for (long long k = k0; k < n_lvl; k += stride) scratch[k] = 0;
        if (k0 == 0) scratch[4LL * n_lvl] = 0;
    }
}

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
                        int super_majority, int r_max) {
    extern __shared__ int32_t smem[];
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
                    // only seen >= super_majority is read: stop once known
                    if (seen >= super_majority || seen + (n - w) < super_majority) break;
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

__global__ void __launch_bounds__(BABBLE_LEVEL_THREADS)
dr_grid(const int32_t* __restrict__ levels,
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
        int32_t* wtable, int32_t* scratch, int n_lvl, int e, int n,
        int super_majority, int r_max, int aligned16) {
    extern __shared__ int4 dr_smem4[];
    int32_t* tile = reinterpret_cast<int32_t*>(dr_smem4);
    __shared__ const int32_t* a_lane[BABBLE_LT];  // the item's lanes' la rows
    __shared__ int s_pr[BABBLE_LT], s_todo[BABBLE_LT];
    // per lane of the level: c_seen, parent round, self-parent round, new
    // lamport; then the barrier's count
    int32_t* c_seen = scratch;
    int32_t* l_pr = c_seen + n_lvl;
    int32_t* l_spr = l_pr + n_lvl;
    int32_t* l_lt = l_spr + n_lvl;
    unsigned int* bar = reinterpret_cast<unsigned int*>(l_lt + n_lvl);
    unsigned int bar_target = 0;
    const int last = *last_level;
    const int n_wt = (n + BABBLE_WT - 1) / BABBLE_WT;
    const int items = (n_lvl + BABBLE_LT - 1) / BABBLE_LT * n_wt;

    for (int lv = 0; lv <= last; ++lv) {
        const int32_t* lrow = levels + (long long)lv * n_lvl;
        // (A) strongly-see counts, item by item
        for (int it = blockIdx.x; it < items; it += gridDim.x) {
            const int lt = it / n_wt, wt = it % n_wt;
            if (threadIdx.x < BABBLE_LT) {
                const int i = lt * BABBLE_LT + threadIdx.x;
                const int row = i < n_lvl ? lrow[i] : -1;
                int pr = -1, todo = 0;
                a_lane[threadIdx.x] = nullptr;
                if (row >= 0) {
                    const int sp = self_parent[row], op = other_parent[row];
                    const int spr = sp >= 0 ? __ldcg(rounds + min(sp, e - 1)) : ext_sp_round[row];
                    const int opr = op >= 0 ? __ldcg(rounds + min(op, e - 1)) : ext_op_round[row];
                    pr = max(spr, opr);
                    if (wt == 0) {
                        const int sp_lt = sp >= 0 ? __ldcg(lamport + min(sp, e - 1))
                                                  : ext_sp_lamport[row];
                        const int op_lt = op >= 0 ? __ldcg(lamport + min(op, e - 1))
                                                  : ext_op_lamport[row];
                        // int32 wrap-around, as the reference's int32 add
                        int lt_new = (int)((unsigned)max(sp_lt, op_lt) + 1u);
                        const int fl = fixed_lamport[row];
                        if (fl != BABBLE_MIN_INT32) lt_new = fl;
                        __stcg(l_pr + i, pr);
                        __stcg(l_spr + i, spr);
                        __stcg(l_lt + i, lt_new);
                    }
                    // parent_round < 0: no witness to count
                    todo = pr >= 0 && __ldcg(c_seen + i) < super_majority;
                    a_lane[threadIdx.x] = la + (long long)row * n;
                }
                s_pr[threadIdx.x] = pr;
                s_todo[threadIdx.x] = todo;
            }
            __syncthreads();
            // one pass per distinct parent round among the item's lanes
            babble_level_item(tile, n, wt, aligned16 != 0, super_majority, a_lane, s_pr, s_todo,
                              c_seen + lt * BABBLE_LT, [&](int p, int w) -> const int32_t* {
                                  const int wr =
                                      __ldcg(wtable + (long long)min(p, r_max - 1) * n + w);
                                  return wr >= 0 ? fd + (long long)min(wr, e - 1) * n : nullptr;
                              });
        }
        babble_grid_sync(bar, bar_target);
        // (B) every lane's results from the counts and the carry as read
        for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_lvl;
             i += gridDim.x * blockDim.x) {
            const int row = lrow[i];
            if (row < 0) continue;
            const int seen = __ldcg(c_seen + i);
            __stcg(c_seen + i, 0);
            int rd = __ldcg(l_pr + i) + (seen >= super_majority ? 1 : 0);
            const int fixed = fixed_round[row];
            if (fixed >= 0) rd = fixed;
            const bool wit = rd > __ldcg(l_spr + i);
            __stcg(rounds + row, rd);
            __stcg(lamport + row, __ldcg(l_lt + i));
            witness[row] = (uint8_t)wit;
            const int c = creator[row];
            if (wit && c >= 0 && c < n) {
                __stcg(wtable + (long long)babble_clamp(rd, 0, r_max - 1) * n + c, row);
            }
        }
        babble_grid_sync(bar, bar_target);
    }
}

extern "C" int babble_divide_rounds(
    const int32_t* levels, const int32_t* creator, const int32_t* self_parent,
    const int32_t* other_parent, const int32_t* la, const int32_t* fd,
    const int32_t* ext_sp_round, const int32_t* ext_op_round,
    const int32_t* fixed_round, const int32_t* ext_sp_lamport,
    const int32_t* ext_op_lamport, const int32_t* fixed_lamport,
    int32_t* rounds, uint8_t* witness, int32_t* lamport, int32_t* wtable,
    int32_t* last_level, int32_t* scratch,
    int l_lv, int n_lvl, int e, int n, int super_majority, int r_max,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long wt_total = (long long)r_max * n;
    long long work = wt_total > e ? wt_total : e;
    // the grid form where the wrapper hands a scratch (tpu/_ext.py
    // divide_rounds_form chooses), else the one-block walk
    dr_init<<<babble_stride_blocks(work, 256), 256, 0, s>>>(
        rounds, lamport, witness, wtable, last_level, scratch, e, wt_total, n_lvl);
    BABBLE_CHECK_LAUNCH();
    long long lv_total = (long long)l_lv * n_lvl;
    if (lv_total > 0) {
        babble_last_level<<<babble_stride_blocks(lv_total, 256), 256, 0, s>>>(
            levels, last_level, lv_total, n_lvl);
        BABBLE_CHECK_LAUNCH();
    }
    if (scratch == nullptr) {
        int warps = n_lvl < DR_MAX_WARPS ? (n_lvl > 0 ? n_lvl : 1) : DR_MAX_WARPS;
        const size_t smem = ((size_t)3 * n_lvl + (size_t)warps * 2 * n) * sizeof(int32_t);
        BABBLE_CHECK(babble_allow_smem(dr_walk, smem));
        dr_walk<<<1, 32 * warps, smem, s>>>(
            levels, creator, self_parent, other_parent, la, fd, ext_sp_round,
            ext_op_round, fixed_round, ext_sp_lamport, ext_op_lamport,
            fixed_lamport, last_level, rounds, witness, lamport, wtable, n_lvl, e,
            n, super_majority, r_max);
        BABBLE_CHECK_LAUNCH();
        return 0;
    }
    const size_t smem = babble_level_item_smem();
    BABBLE_CHECK(babble_allow_smem(dr_grid, smem));
    const long long items =
        (long long)(n_lvl + BABBLE_LT - 1) / BABBLE_LT * ((n + BABBLE_WT - 1) / BABBLE_WT);
    if (items == 0) return 0;  // no lane: nothing to walk
    int g = 0;
    BABBLE_CHECK(babble_coop_blocks(dr_grid, BABBLE_LEVEL_THREADS, smem, device, items, &g));
    const int aligned16 = babble_rows_aligned16(la, n) && babble_rows_aligned16(fd, n);
    void* args[] = {
        (void*)&levels, (void*)&creator, (void*)&self_parent, (void*)&other_parent,
        (void*)&la, (void*)&fd, (void*)&ext_sp_round, (void*)&ext_op_round,
        (void*)&fixed_round, (void*)&ext_sp_lamport, (void*)&ext_op_lamport,
        (void*)&fixed_lamport, (void*)&last_level, (void*)&rounds, (void*)&witness,
        (void*)&lamport, (void*)&wtable, (void*)&scratch, (void*)&n_lvl, (void*)&e,
        (void*)&n, (void*)&super_majority, (void*)&r_max, (void*)&aligned16,
    };
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)dr_grid, dim3(g),
                                             dim3(BABBLE_LEVEL_THREADS), args, smem, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}
