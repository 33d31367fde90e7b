// step_levels: the within-batch level scan of one append batch.
//
// Replaces babble_tpu/tpu/incremental.py:243 _step_body: its front half
// _apply_deltas_and_stage (:213) as phase 0 of the launch
// (apply_deltas.cuh: the fd delta min-scatter, its mirror into fd_w
// through the pre-batch w_of_row, the new rows' staging), over the whole
// grid, before any level, in both walks, and its level half after it.
// Phase 0 ends at a barrier (the grid's, or the block's), so that its
// mirror has read w_of_row before any level registers a witness (which
// writes w_of_row and fd_w), and the levels read fd and fd_w, which its
// atomics wrote in L2, through L2 (__ldcg, cp.async.cg). Then, in place,
// for each of the batch's L levels in order and each lane of the level (a
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
// a few nanoseconds at 3.35 TB/s, and its compares (lanes x witnesses x N
// per level) a few microseconds at the ALU rate at 1,024 validators; but
// level k+1 reads what level k wrote, so the levels run in order. Two
// forms, chosen by the wrapper (tpu/_ext.py step_levels_form: by width):
//
// sl_walk, narrow batches: one block walks the levels. Barriers separate
// each level's read phases (JAX reads the whole carry before it scatters,
// so no lane may see another lane's write of the same level, whose
// witnesses can land in the round another lane reads) from its write
// phase, and a last barrier makes the writes visible to the next level.
// The level table, the batch's small arrays and the witness-valid mask are
// staged in shared memory once, and the walk ends at the last level that
// holds an event. Per level: phase A reads each lane's la row and parents,
// phase C decides whether each lane strongly sees a supermajority of its
// parent round's witnesses, reading their fd_w rows (one warp per lane,
// lanes over coordinates, eight witnesses at a time, ballots, stopping
// once the verdict is known: common.cuh babble_warp_sees_majority), and
// the write phase stores.
//
// sl_grid, wider batches: a cooperative launch over as many blocks as the
// card holds at once (at most one per work item), two barriers across the
// grid per level, as divide_rounds.cu dr_grid:
//   (A) a work item is (8 lanes) x (32 witnesses) of the level; the block
//       takes the lanes' parent rounds from the rounds written at earlier
//       levels and, per distinct parent round among them, counts the lanes'
//       la rows against the fd_w rows of that round's witnesses (present
//       where wtable >= 0) through the compare-count tile (common.cuh
//       babble_level_item), adding each lane's verdicts into its c_seen in
//       a scratch; a lane whose c_seen already reaches the supermajority
//       skips its remaining items. The item of witness tile 0 also records
//       each lane's parent round, self-parent round and new lamport, read
//       before any write of the level;
//   (B) after the barrier, a warp per lane: its round, witness flag and
//       lamport follow from those and c_seen (reset for the next level);
//       the row is written, a witness registers (wtable, w_of_row, idx_w,
//       coin_w and the N-wide la_w and fd_w rows); then the second barrier.
// After the last level that holds an event every block takes the max of
// its share of the rows' rounds, and the last block to finish adds the
// count and sets the latches. Everything the walk writes and reads back
// (rounds, lamport, wtable, fd, fd_w, the per-lane carries) goes through L2
// (__ldcg / __stcg, cp.async.cg). Shared memory per block is the tile's
// ring, the same at every width.
//
// A padding lane writes nothing (JAX's dropped scatter).
//
// The packed layout (babble_tpu/tpu/incremental.py:280-283, packed=True)
// counts the same compares with packed_count and c_seen as the popcount of
// the strongly-seen words: the same verdicts, so the wrapper launches this
// kernel for both layouts (counted apart).

#include "apply_deltas.cuh"

#define SL_THREADS 1024
#define SL_WARPS (SL_THREADS / 32)

__global__ void __launch_bounds__(SL_THREADS)
sl_walk(int32_t* fd, int32_t* rounds, int32_t* lamport,
        uint8_t* witness, int32_t* wtable, int32_t* w_of_row, int32_t* la_w,
        int32_t* fd_w, int32_t* idx_w, uint8_t* coin_w,
        const uint8_t* __restrict__ rounds_decided, int32_t* last_round,
        int32_t* count, uint8_t* stale,
        const int32_t* __restrict__ rows, const int32_t* __restrict__ creator,
        const int32_t* __restrict__ index, const int32_t* __restrict__ sp_row,
        const int32_t* __restrict__ op_row, const int32_t* __restrict__ la_rows,
        const uint8_t* __restrict__ coin, const int32_t* __restrict__ fixed_round,
        const int32_t* __restrict__ levels, int32_t* la, int32_t* s_creator,
        int32_t* s_index, const int32_t* __restrict__ upd_row,
        const int32_t* __restrict__ upd_col, const int32_t* __restrict__ upd_val,
        int e_cap, int n, int r_cap, int b, int l_lv, int w, int super_majority, int u) {
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

    // phase 0 (K9): its writes are the block's, visible after the
    // staging's barriers
    babble_apply_deltas_range(fd, fd_w, la, s_creator, s_index, w_of_row, rows, creator, index,
                              la_rows, upd_row, upd_col, upd_val, e_cap, n, r_cap, b, u,
                              threadIdx.x, blockDim.x);
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
            fd_w[(long long)slot * n + q] = __ldcg(fd + (long long)row * n + q);
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

__global__ void __launch_bounds__(BABBLE_LEVEL_THREADS)
sl_grid(int32_t* fd, int32_t* rounds, int32_t* lamport,
        uint8_t* witness, int32_t* wtable, int32_t* w_of_row, int32_t* la_w,
        int32_t* fd_w, int32_t* idx_w, uint8_t* coin_w,
        const uint8_t* __restrict__ rounds_decided, int32_t* last_round,
        int32_t* count, uint8_t* stale,
        const int32_t* __restrict__ rows, const int32_t* __restrict__ creator,
        const int32_t* __restrict__ index, const int32_t* __restrict__ sp_row,
        const int32_t* __restrict__ op_row, const int32_t* __restrict__ la_rows,
        const uint8_t* __restrict__ coin, const int32_t* __restrict__ fixed_round,
        const int32_t* __restrict__ levels, int32_t* scratch, int32_t* la,
        int32_t* s_creator, int32_t* s_index, const int32_t* __restrict__ upd_row,
        const int32_t* __restrict__ upd_col, const int32_t* __restrict__ upd_val,
        int e_cap, int n, int r_cap, int b, int l_lv, int w, int super_majority, int u,
        int aligned16) {
    extern __shared__ int4 sl_smem4[];
    int32_t* tile = reinterpret_cast<int32_t*>(sl_smem4);
    __shared__ const int32_t* a_lane[BABBLE_LT];  // the item's lanes' la rows
    __shared__ int s_pr[BABBLE_LT], s_todo[BABBLE_LT];
    __shared__ int s_last, s_cnt;
    // per lane of the level: c_seen, parent round, self-parent round, new
    // lamport; then the barrier's count, the last block's ticket and the
    // rounds' max (babble_max_key), all 0 at launch
    int32_t* c_seen = scratch;
    int32_t* l_pr = c_seen + w;
    int32_t* l_spr = l_pr + w;
    int32_t* l_lt = l_spr + w;
    unsigned int* bar = reinterpret_cast<unsigned int*>(l_lt + w);
    unsigned int* ticket = bar + 1;
    unsigned int* max_key = bar + 2;
    unsigned int bar_target = 0;
    const int lane = threadIdx.x & 31;

    // phase 0 (K9), over the whole grid
    babble_apply_deltas_range(fd, fd_w, la, s_creator, s_index, w_of_row, rows, creator, index,
                              la_rows, upd_row, upd_col, upd_val, e_cap, n, r_cap, b, u,
                              (long long)blockIdx.x * blockDim.x + threadIdx.x,
                              (long long)gridDim.x * blockDim.x);
    // the last level that holds an event (levels past it are no-ops)
    if (threadIdx.x == 0) {
        s_last = -1;
        s_cnt = 0;
    }
    __syncthreads();
    int best = -1;
    for (int k = threadIdx.x; k < l_lv * w; k += blockDim.x) {
        if (levels[k] >= 0) best = max(best, k / w);
    }
    best = __reduce_max_sync(BABBLE_FULL_MASK, best);
    if (lane == 0 && best >= 0) atomicMax(&s_last, best);
    __syncthreads();
    const int last = s_last;
    const int n_wt = (n + BABBLE_WT - 1) / BABBLE_WT;
    const int items = (w + BABBLE_LT - 1) / BABBLE_LT * n_wt;
    const int warp_g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int warps_g = (gridDim.x * blockDim.x) >> 5;
    // phase 0's mirror has read the pre-batch w_of_row, and its fd and fd_w
    // atomics are done, before any level reads or registers
    babble_grid_sync(bar, bar_target);

    for (int lv = 0; lv <= last; ++lv) {
        const int32_t* lrow = levels + (long long)lv * w;
        // (A) strongly-see counts, item by item
        for (int it = blockIdx.x; it < items; it += gridDim.x) {
            const int lt = it / n_wt, wt = it % n_wt;
            if (threadIdx.x < BABBLE_LT) {
                const int i = lt * BABBLE_LT + threadIdx.x;
                const int pos = i < w ? lrow[i] : -1;
                int pr = -1, todo = 0;
                a_lane[threadIdx.x] = nullptr;
                if (pos >= 0) {
                    const int p = min(pos, b - 1);
                    const int sp = sp_row[p], op = op_row[p];
                    const int spr = sp >= 0 ? __ldcg(rounds + min(sp, e_cap - 1)) : -1;
                    const int opr = op >= 0 ? __ldcg(rounds + min(op, e_cap - 1)) : -1;
                    pr = max(spr, opr);
                    if (wt == 0) {
                        const int sp_lt = sp >= 0 ? __ldcg(lamport + min(sp, e_cap - 1)) : -1;
                        const int op_lt = op >= 0 ? __ldcg(lamport + min(op, e_cap - 1)) : -1;
                        __stcg(l_pr + i, pr);
                        __stcg(l_spr + i, spr);
                        // int32 wrap-around, as the reference's int32 add
                        __stcg(l_lt + i, (int)((unsigned)max(sp_lt, op_lt) + 1u));
                    }
                    // parent_round < 0: no witness to count
                    todo = pr >= 0 && __ldcg(c_seen + i) < super_majority;
                    a_lane[threadIdx.x] = la_rows + (long long)p * n;
                }
                s_pr[threadIdx.x] = pr;
                s_todo[threadIdx.x] = todo;
            }
            __syncthreads();
            // one pass per distinct parent round among the item's lanes
            babble_level_item(tile, n, wt, aligned16 != 0, super_majority, a_lane, s_pr, s_todo,
                              c_seen + lt * BABBLE_LT, [&](int p, int wi) -> const int32_t* {
                                  const long long slot = (long long)min(p, r_cap - 1) * n + wi;
                                  return __ldcg(wtable + slot) >= 0 ? fd_w + slot * n : nullptr;
                              });
        }
        babble_grid_sync(bar, bar_target);
        // (B) a warp per lane: its results from the counts and the carry as
        // read, its row, and a witness's registration
        for (int i = warp_g; i < w; i += warps_g) {
            const int pos = lrow[i];
            if (pos < 0) continue;  // padding lane (warp-uniform)
            const int p = min(pos, b - 1);
            int slot = -1, row = 0;
            if (lane == 0) {
                const int seen = __ldcg(c_seen + i);
                __stcg(c_seen + i, 0);
                int rd = __ldcg(l_pr + i) + (seen >= super_majority ? 1 : 0);
                if (fixed_round[p] >= 0) rd = fixed_round[p];
                const bool wit = rd > __ldcg(l_spr + i);
                const int c = creator[p];
                row = rows[p];
                const bool in_cap = row >= 0 && row < e_cap;
                if (in_cap) {
                    __stcg(rounds + row, rd);
                    __stcg(lamport + row, __ldcg(l_lt + i));
                    witness[row] = (uint8_t)wit;
                }
                if (wit && c >= 0 && c < n) {
                    slot = babble_clamp(rd, 0, r_cap - 1) * n + c;
                    __stcg(wtable + slot, row);
                    if (in_cap) w_of_row[row] = slot;
                    idx_w[slot] = index[p];
                    coin_w[slot] = coin[p];
                }
            }
            slot = __shfl_sync(BABBLE_FULL_MASK, slot, 0);
            row = __shfl_sync(BABBLE_FULL_MASK, row, 0);
            if (slot < 0) continue;
            // the witness's own fd row as it stands: this batch's deltas included
            const int32_t* la_src = la_rows + (long long)p * n;
            const int32_t* fd_src = fd + (long long)babble_clamp(row, 0, e_cap - 1) * n;
            // phase 0's atomics and other blocks' rows: through L2
            int32_t* la_dst = la_w + (long long)slot * n;
            int32_t* fd_dst = fd_w + (long long)slot * n;
            for (int q = lane; q < n; q += 32) {
                la_dst[q] = la_src[q];
                __stcg(fd_dst + q, __ldcg(fd_src + q));
            }
        }
        babble_grid_sync(bar, bar_target);
    }

    // last_round over every row (each block its share), then the count and
    // the two latches in the last block to finish
    int m = BABBLE_MIN_INT32;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < e_cap;
         k += (long long)gridDim.x * blockDim.x) {
        m = max(m, __ldcg(rounds + k));
    }
    m = __reduce_max_sync(BABBLE_FULL_MASK, m);
    if (lane == 0) {
        atomicMax(max_key, babble_max_key(m));
        __threadfence();
    }
    if (!babble_last_block(ticket)) return;
    int cnt = 0, late = 0;
    for (int k = threadIdx.x; k < b; k += blockDim.x) {
        const int r = rows[k];
        if (r < 0) continue;
        ++cnt;
        int br = -1, bw = 0;
        if (r < e_cap) {
            br = __ldcg(rounds + r);
            bw = __ldcg(witness + r);
        }
        const int rd = rounds_decided[babble_clamp(br, 0, r_cap - 1)];
        late |= bw && rd && br >= 0 && br < r_cap;
    }
    cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
    if (lane == 0 && cnt) atomicAdd(&s_cnt, cnt);
    late = __syncthreads_or(late);
    if (threadIdx.x == 0) {
        const int lr = max(*last_round, babble_max_of_key(atomicOr(max_key, 0u)));
        *last_round = lr;
        *count = (int)((unsigned)*count + (unsigned)s_cnt);
        if (lr >= r_cap - 1 || late) *stale = 1;
    }
}

extern "C" int babble_step_levels(
    int32_t* fd, int32_t* rounds, int32_t* lamport, uint8_t* witness,
    int32_t* wtable, int32_t* w_of_row, int32_t* la_w, int32_t* fd_w,
    int32_t* idx_w, uint8_t* coin_w, const uint8_t* rounds_decided,
    int32_t* last_round, int32_t* count, uint8_t* stale, const int32_t* rows,
    const int32_t* creator, const int32_t* index, const int32_t* sp_row,
    const int32_t* op_row, const int32_t* la_rows, const uint8_t* coin,
    const int32_t* fixed_round, const int32_t* levels, int32_t* scratch, int32_t* la,
    int32_t* s_creator, int32_t* s_index, const int32_t* upd_row, const int32_t* upd_col,
    const int32_t* upd_val, int e_cap, int n, int r_cap, int b, int l_lv, int w,
    int super_majority, int u, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the grid walk where the wrapper hands a scratch (tpu/_ext.py
    // step_levels_form chooses), else the one-block walk; both run K9 as
    // phase 0
    if (scratch == nullptr) {
        const size_t smem =
            ((size_t)7 * w + (size_t)l_lv * w + (size_t)7 * b + (size_t)w * n) * sizeof(int32_t)
            + (size_t)r_cap * n;
        BABBLE_CHECK(babble_allow_smem(sl_walk, smem));
        sl_walk<<<1, SL_THREADS, smem, s>>>(
            fd, rounds, lamport, witness, wtable, w_of_row, la_w, fd_w, idx_w,
            coin_w, rounds_decided, last_round, count, stale, rows, creator, index,
            sp_row, op_row, la_rows, coin, fixed_round, levels, la, s_creator, s_index,
            upd_row, upd_col, upd_val, e_cap, n, r_cap, b, l_lv, w, super_majority, u);
        BABBLE_CHECK_LAUNCH();
        return 0;
    }
    // the per-lane carries and the three counters start at 0 (the barrier's
    // count must be 0 at launch)
    BABBLE_CHECK(cudaMemsetAsync(scratch, 0, ((size_t)4 * w + 3) * sizeof(int32_t), s));
    const size_t smem = babble_level_item_smem();
    BABBLE_CHECK(babble_allow_smem(sl_grid, smem));
    const long long items =
        (long long)(w + BABBLE_LT - 1) / BABBLE_LT * ((n + BABBLE_WT - 1) / BABBLE_WT);
    int g = 0;
    BABBLE_CHECK(babble_coop_blocks(sl_grid, BABBLE_LEVEL_THREADS, smem, device, items, &g));
    const int aligned16 = babble_rows_aligned16(la_rows, n) && babble_rows_aligned16(fd_w, n);
    void* args[] = {
        (void*)&fd, (void*)&rounds, (void*)&lamport, (void*)&witness, (void*)&wtable,
        (void*)&w_of_row, (void*)&la_w, (void*)&fd_w, (void*)&idx_w, (void*)&coin_w,
        (void*)&rounds_decided, (void*)&last_round, (void*)&count, (void*)&stale,
        (void*)&rows, (void*)&creator, (void*)&index, (void*)&sp_row, (void*)&op_row,
        (void*)&la_rows, (void*)&coin, (void*)&fixed_round, (void*)&levels,
        (void*)&scratch, (void*)&la, (void*)&s_creator, (void*)&s_index, (void*)&upd_row,
        (void*)&upd_col, (void*)&upd_val, (void*)&e_cap, (void*)&n, (void*)&r_cap, (void*)&b,
        (void*)&l_lv, (void*)&w, (void*)&super_majority, (void*)&u, (void*)&aligned16,
    };
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)sl_grid, dim3(g),
                                             dim3(BABBLE_LEVEL_THREADS), args, smem, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}
