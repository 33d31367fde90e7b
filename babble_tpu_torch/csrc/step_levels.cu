// step_levels: the within-batch level scan of one append batch.
//
// Replaces the level half of babble_tpu/tpu/incremental.py:243 _step_body
// (after _apply_deltas_and_stage, which is apply_deltas.cu). In place, for
// each of the batch's L levels in order and each lane of the level (a
// position p into the batch, -1 = padding):
//   parent_round = max(rounds[sp_row[p]], rounds[op_row[p]])  (-1 = none)
//   c_seen       = |{w : wtable[pr, w] >= 0 and
//                        |{q : la_rows[p, q] >= fd_w[pr, w, q]}| >= sm}|
//                  with pr = clip(parent_round, 0, R_cap-1), 0 if parent_round < 0
//   round        = parent_round + (c_seen >= sm), unless fixed_round[p] >= 0
//   witness      = round > rounds[sp_row[p]]
//   lamport      = max(lamport of the parents) + 1
// written to the batch's row, and a witness registers into the dense
// buffers at slot clip(round, 0, R_cap-1) * N + creator: wtable, w_of_row,
// la_w (its la row), fd_w (its current fd row, this batch's deltas
// included), idx_w, coin_w. Then last_round = max(last_round, max(rounds)),
// count += the batch's rows, and stale latches the round-capacity overflow
// (last_round >= R_cap-1) and a late witness (one registering into an
// already-decided round).
//
// Bound: the chain of dependent levels. The bytes the batch needs (its la
// rows, the parent rounds' fd_w rows, the registrations) are tens of KB,
// a few nanoseconds at 3.35 TB/s; level k+1 reads what level k wrote.
// Design: one block walks the levels. Barriers separate each level's
// read phases (JAX reads the whole carry before it scatters, so no lane
// may see another lane's write of the same level, whose witnesses can
// land in the round another lane reads) from its write phase, and a
// last barrier makes the writes visible to the next level. The level
// table, the batch's small arrays and the witness-valid mask are staged in
// shared memory once, and the walk ends at the last level that holds an
// event. Per level: phase A reads each lane's la row and parents, phase C
// decides whether each lane strongly sees a supermajority of its parent
// round's witnesses, reading their fd_w rows (one warp per lane, lanes
// over coordinates, eight witnesses at a time, ballots, stopping once the
// verdict is known: common.cuh babble_warp_sees_majority), and the write
// phase stores. A padding lane writes nothing (JAX's dropped scatter).

#include "common.cuh"

#define SL_THREADS 1024
#define SL_WARPS (SL_THREADS / 32)

__global__ void __launch_bounds__(SL_THREADS)
sl_walk(const int32_t* __restrict__ fd, int32_t* rounds, int32_t* lamport,
        uint8_t* witness, int32_t* wtable, int32_t* w_of_row, int32_t* la_w,
        int32_t* fd_w, int32_t* idx_w, uint8_t* coin_w,
        const uint8_t* __restrict__ rounds_decided, int32_t* last_round,
        int32_t* count, uint8_t* stale,
        const int32_t* __restrict__ rows, const int32_t* __restrict__ creator,
        const int32_t* __restrict__ index, const int32_t* __restrict__ sp_row,
        const int32_t* __restrict__ op_row, const int32_t* __restrict__ la_rows,
        const uint8_t* __restrict__ coin, const int32_t* __restrict__ fixed_round,
        const int32_t* __restrict__ levels,
        int e_cap, int n, int r_cap, int b, int l_lv, int w, int super_majority) {
    extern __shared__ int32_t smem[];
    int32_t* s_p = smem;           // (w,) per lane: batch position, -1 = padding
    int32_t* s_pr = s_p + w;       //   parent round
    int32_t* s_spr = s_pr + w;     //   self-parent round
    int32_t* s_lt = s_spr + w;     //   new lamport
    int32_t* s_round = s_lt + w;   //   new round
    int32_t* s_wit = s_round + w;  //   new witness flag
    int32_t* s_slot = s_wit + w;   //   registration slot, -1 = none
    int32_t* lv_s = s_slot + w;    // (l_lv, w) the level table
    int32_t* b_rows = lv_s + l_lv * w;  // (b,) the batch's small arrays
    int32_t* b_creator = b_rows + b;
    int32_t* b_index = b_creator + b;
    int32_t* b_sp = b_index + b;
    int32_t* b_op = b_sp + b;
    int32_t* b_fixed = b_op + b;
    int32_t* b_coin = b_fixed + b;
    int32_t* la_lane = b_coin + b;  // (w, n) the lanes' la rows
    uint8_t* wv = (uint8_t*)(la_lane + w * n);  // (r_cap * n,) wtable >= 0
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __shared__ int red_max, red_cnt, last_lv;

    // the level table, the batch's metadata and the witness-valid mask,
    // fetched once
    if (threadIdx.x == 0) last_lv = -1;
    for (int k = threadIdx.x; k < b; k += blockDim.x) {
        b_rows[k] = rows[k];
        b_creator[k] = creator[k];
        b_index[k] = index[k];
        b_sp[k] = sp_row[k];
        b_op[k] = op_row[k];
        b_fixed[k] = fixed_round[k];
        b_coin[k] = coin[k];
    }
    for (int k = threadIdx.x; k < r_cap * n; k += blockDim.x) wv[k] = wtable[k] >= 0;
    __syncthreads();
    for (int k = threadIdx.x; k < l_lv * w; k += blockDim.x) {
        lv_s[k] = levels[k];
        if (lv_s[k] >= 0) atomicMax(&last_lv, k / w);
    }
    __syncthreads();
    const int lv_end = last_lv;  // levels past it are padding: no-ops

    for (int lv = 0; lv <= lv_end; ++lv) {
        const int32_t* lrow = lv_s + lv * w;
        // phase A: each lane's la row and parents (one round trip)
        for (int i = warp; i < w; i += SL_WARPS) {
            const int pos = lrow[i];
            if (pos < 0) {  // padding lane (warp-uniform)
                if (lane == 0) s_p[i] = s_slot[i] = -1;
                continue;
            }
            const int p = min(pos, b - 1);
            for (int q = lane; q < n; q += 32) {
                la_lane[i * n + q] = la_rows[(long long)p * n + q];
            }
            if (lane == 0) {
                const int sp = b_sp[p], op = b_op[p];
                const int sp_round = sp >= 0 ? rounds[min(sp, e_cap - 1)] : -1;
                const int op_round = op >= 0 ? rounds[min(op, e_cap - 1)] : -1;
                const int sp_lt = sp >= 0 ? lamport[min(sp, e_cap - 1)] : -1;
                const int op_lt = op >= 0 ? lamport[min(op, e_cap - 1)] : -1;
                const int pr = max(sp_round, op_round);
                s_p[i] = p;
                s_pr[i] = pr;
                s_spr[i] = sp_round;
                // int32 wrap-around, as the reference's int32 add
                s_lt[i] = (int)((unsigned)max(sp_lt, op_lt) + 1u);
            }
        }
        __syncthreads();
        // phase C: the strongly-seen counts
        for (int i = warp; i < w; i += SL_WARPS) {
            const int p = s_p[i];
            if (p < 0) continue;  // warp-uniform
            const int pr = s_pr[i];
            const int prc = babble_clamp(pr, 0, r_cap - 1);
            const uint8_t* wv_r = wv + prc * n;
            const bool sees = pr >= 0 && babble_warp_sees_majority(
                la_lane + i * n, fd_w + (long long)prc * n * n, n, super_majority,
                [wv_r](int wi) { return wv_r[wi] != 0; });
            if (lane == 0) {
                int rd = pr + (sees ? 1 : 0);
                if (b_fixed[p] >= 0) rd = b_fixed[p];
                const int wit = rd > s_spr[i];
                const int c = b_creator[p];
                s_round[i] = rd;
                s_wit[i] = wit;
                s_slot[i] = (wit && c >= 0 && c < n)
                                ? babble_clamp(rd, 0, r_cap - 1) * n + c : -1;
            }
        }
        __syncthreads();
        // write phase: the lanes' rows, then the registered witness rows
        for (int i = threadIdx.x; i < w; i += blockDim.x) {
            const int p = s_p[i];
            if (p < 0) continue;
            const int row = b_rows[p];
            const bool in_cap = row >= 0 && row < e_cap;
            if (in_cap) {
                rounds[row] = s_round[i];
                lamport[row] = s_lt[i];
                witness[row] = (uint8_t)s_wit[i];
            }
            const int slot = s_slot[i];
            if (slot >= 0) {
                wtable[slot] = row;
                wv[slot] = row >= 0;
                if (in_cap) w_of_row[row] = slot;
                idx_w[slot] = b_index[p];
                coin_w[slot] = (uint8_t)b_coin[p];
            }
        }
        for (int k = threadIdx.x; k < w * n; k += blockDim.x) {
            const int i = k / n, q = k % n;
            const int slot = s_slot[i];
            if (slot < 0) continue;
            const int p = s_p[i];
            const int row = babble_clamp(b_rows[p], 0, e_cap - 1);
            la_w[(long long)slot * n + q] = la_rows[(long long)p * n + q];
            fd_w[(long long)slot * n + q] = fd[(long long)row * n + q];
        }
        __syncthreads();
    }

    // last_round over every row, count, and the two latches
    if (threadIdx.x == 0) {
        red_max = *last_round;
        red_cnt = 0;
    }
    __syncthreads();
    int m = BABBLE_MIN_INT32;
    for (int k = threadIdx.x; k < e_cap; k += blockDim.x) m = max(m, rounds[k]);
    m = __reduce_max_sync(BABBLE_FULL_MASK, m);
    if (lane == 0) atomicMax(&red_max, m);
    int cnt = 0, late = 0;
    for (int i = threadIdx.x; i < b; i += blockDim.x) {
        const int r = b_rows[i];
        if (r < 0) continue;
        ++cnt;
        int br = -1, bw = 0;
        if (r < e_cap) {
            br = rounds[r];
            bw = witness[r];
        }
        const int rd = rounds_decided[babble_clamp(br, 0, r_cap - 1)];
        late |= bw && rd && br >= 0 && br < r_cap;
    }
    cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
    if (lane == 0 && cnt) atomicAdd(&red_cnt, cnt);
    late = __syncthreads_or(late);
    if (threadIdx.x == 0) {
        const int lr = red_max;
        *last_round = lr;
        *count = (int)((unsigned)*count + (unsigned)red_cnt);
        if (lr >= r_cap - 1 || late) *stale = 1;
    }
}

extern "C" int babble_step_levels(
    const int32_t* fd, int32_t* rounds, int32_t* lamport, uint8_t* witness,
    int32_t* wtable, int32_t* w_of_row, int32_t* la_w, int32_t* fd_w,
    int32_t* idx_w, uint8_t* coin_w, const uint8_t* rounds_decided,
    int32_t* last_round, int32_t* count, uint8_t* stale, const int32_t* rows,
    const int32_t* creator, const int32_t* index, const int32_t* sp_row,
    const int32_t* op_row, const int32_t* la_rows, const uint8_t* coin,
    const int32_t* fixed_round, const int32_t* levels,
    int e_cap, int n, int r_cap, int b, int l_lv, int w, int super_majority,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    size_t smem = ((size_t)7 * w + (size_t)l_lv * w + (size_t)7 * b + (size_t)w * n)
                      * sizeof(int32_t)
                  + (size_t)r_cap * n;
    if (smem > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            sl_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    }
    sl_walk<<<1, SL_THREADS, smem, s>>>(
        fd, rounds, lamport, witness, wtable, w_of_row, la_w, fd_w, idx_w,
        coin_w, rounds_decided, last_round, count, stale, rows, creator, index,
        sp_row, op_row, la_rows, coin, fixed_round, levels, e_cap, n, r_cap, b,
        l_lv, w, super_majority);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
