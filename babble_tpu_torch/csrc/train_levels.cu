// train_levels: the level scan of one whole append train.
//
// Replaces babble_tpu/tpu/incremental.py:570 _train_body after its deltas
// (apply_deltas.cu). In place:
//   1. the scan over the train's (T, W) level table, with train-local
//      carries: rounds_b, lamport_b, witness_b of the train's KB rows, a
//      compare copy of fd_w clamped to FD_CLAMP = 2^24 and a copy of the
//      witness-valid mask. Per lane (train position p, -1 = padding):
//        parent rounds / lamports from the carries for in-train parents
//        (sp_pos / op_pos >= 0), else from the state's pre-train rounds /
//        lamport (-1 outside [0, E_cap));
//        c_seen, round, witness and lamport as in step_levels.cu, against
//        the compare copies;
//        a witness registers into the compare copies at slot
//        clip(round, 0, R_cap-1) * N + creator: its fd row (after the
//        train's deltas) clamped to 2^24, and valid = 1;
//   2. the bulk registration of the train's witnesses whose round is below
//      R_cap (wtable, la_w, fd_w with the CLAMPED row, as the reference
//      stores it, idx_w, coin_w, w_of_row), and one write-back of rounds,
//      lamport and witness to the train's rows;
//   3. last_round = max(last_round, max over the train's rows), count, and
//      the round-capacity and late-witness latches.
// The reference does every carry-dependent gather as a one-hot fp32 matmul
// (values < 2^24, so exact); direct integer loads give the same integers.
//
// Bound: the chain of dependent levels (up to 832 on the bench grid's
// trains). The bytes the train needs are its inputs (KB la rows, the
// parents' rounds, U deltas are apply_deltas.cu's) and the registrations,
// a few MB. Both forms first fill the compare copy of fd_w (R_cap x N x N
// int32, 1 MB at 64 x 64 x 64) in a global scratch buffer with a grid-wide
// launch (tl_init). Then, chosen by the wrapper (tpu/_ext.py
// train_levels_form: by width):
//
// tl_walk, narrow trains: one block walks the levels, the carries in
// shared memory (KB = 8,192 rows: 72 KB) with the valid mask (R_cap x N
// bytes). Per level, phase A reads each lane's inputs, phase C decides
// each lane's supermajority against the compare copy with ballots
// (common.cuh babble_warp_sees_majority), and the write phase updates the
// carries. The write-back and the latches run once after the scan.
//
// tl_grid, wider trains: a cooperative launch, the carries and the valid
// mask in a global scratch that tl_init also fills, two barriers across
// the grid per level, as divide_rounds.cu dr_grid:
//   (A) a work item is (8 lanes) x (32 witnesses) of the level: the lanes'
//       parent rounds (in-train parents from the carries, the others from
//       the state's pre-train rounds), and per distinct parent round their
//       la rows counted against the compare rows of that round's valid
//       witnesses (common.cuh babble_level_item) into per-lane c_seen; the
//       item of witness tile 0 records each lane's parent round,
//       self-parent round and new lamport;
//   (B) a warp per lane: its round, witness flag and lamport into the
//       carries; a witness registers into the compare copies at slot
//       clip(round, 0, R_cap-1) * N + creator, overflow or not.
// After the last level that holds an event the bulk registration, the
// write-back and the latches' shares run over the grid, and the last
// block to finish sets last_round, count and the latches. Everything the
// walk writes and reads back goes through L2 (__ldcg / __stcg,
// cp.async.cg). Shared memory per block is the tile's ring, the same at
// every width.
//
// The packed layout (babble_tpu/tpu/incremental.py:649-652) counts the
// same compares with packed_count over uint32 words: the same integers,
// so the wrapper launches this kernel for both layouts (counted apart).

#include "common.cuh"

#define TL_THREADS 1024
#define TL_WARPS (TL_THREADS / 32)
#define TL_FD_CLAMP (1 << 24)
// tl_grid's counter words in its scratch, after the per-lane carries
#define TL_COUNTERS 8

// fd_cmp = min(fd_w, 2^24), the compare copy the scan starts from; for
// the grid walk (carries non-null) also the carries' initial values, the
// witness-valid copy and *last_p1 = 1 + the last level that holds an event
// (the caller zeroes it first)
__global__ void tl_init(const int32_t* __restrict__ fd_w, int32_t* fd_cmp, long long total,
                        const int32_t* __restrict__ wtable, const int32_t* __restrict__ levels,
                        int32_t* rb, int32_t* lb, uint8_t* wb, uint8_t* wv, int32_t* last_p1,
                        int kb, int n_slots, long long lv_total, int w) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long k0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long k = k0; k < total; k += stride) fd_cmp[k] = min(fd_w[k], TL_FD_CLAMP);
    if (rb == nullptr) return;
    for (long long k = k0; k < kb; k += stride) {
        rb[k] = -1;
        lb[k] = -1;
        wb[k] = 0;
    }
    for (long long k = k0; k < n_slots; k += stride) wv[k] = wtable[k] >= 0;
    int best = 0;
    for (long long k = k0; k < lv_total; k += stride) {
        if (levels[k] >= 0) best = max(best, (int)(k / w) + 1);
    }
    best = __reduce_max_sync(BABBLE_FULL_MASK, best);
    if ((threadIdx.x & 31) == 0 && best > 0) atomicMax(last_p1, best);
}

// a pre-train parent's value: -1 for no parent or a row outside the state
__device__ __forceinline__ int tl_pre(const int32_t* a, int row, int e_cap) {
    return (row >= 0 && row < e_cap) ? a[row] : -1;
}

// the train row's fd coordinate after its deltas, clamped to 2^24
__device__ __forceinline__ int tl_fd_row(const int32_t* fd, int row, int q,
                                         int n, int e_cap) {
    return (row >= 0 && row < e_cap) ? min(fd[(long long)row * n + q], TL_FD_CLAMP)
                                     : TL_FD_CLAMP;
}

__global__ void __launch_bounds__(TL_THREADS)
tl_walk(const int32_t* __restrict__ fd, int32_t* rounds, int32_t* lamport,
        uint8_t* witness, int32_t* wtable, int32_t* w_of_row, int32_t* la_w,
        int32_t* fd_w, int32_t* idx_w, uint8_t* coin_w,
        const uint8_t* __restrict__ rounds_decided, int32_t* last_round,
        int32_t* count, uint8_t* stale,
        const int32_t* __restrict__ rows, const int32_t* __restrict__ creator,
        const int32_t* __restrict__ index, const int32_t* __restrict__ sp_row,
        const int32_t* __restrict__ op_row, const int32_t* __restrict__ sp_pos,
        const int32_t* __restrict__ op_pos, const int32_t* __restrict__ la_rows,
        const uint8_t* __restrict__ coin, const int32_t* __restrict__ fixed_round,
        const int32_t* __restrict__ levels, int32_t* fd_cmp,
        int e_cap, int n, int r_cap, int kb, int t_lv, int w, int super_majority) {
    extern __shared__ int32_t smem[];
    int32_t* rb = smem;              // (kb,) rounds carry
    int32_t* lb = rb + kb;           // (kb,) lamport carry
    int32_t* s_p = lb + kb;          // (w,) per lane: train position, -1 = padding
    int32_t* s_pr = s_p + w;         //   parent round
    int32_t* s_spr = s_pr + w;       //   self-parent round
    int32_t* s_lt = s_spr + w;       //   new lamport
    int32_t* s_fix = s_lt + w;       //   fixed round
    int32_t* s_c = s_fix + w;        //   creator
    int32_t* s_round = s_c + w;      //   new round
    int32_t* s_wit = s_round + w;    //   new witness flag
    int32_t* s_slot = s_wit + w;     //   compare-copy slot, -1 = none
    int32_t* la_lane = s_slot + w;   // (w, n) the lanes' la rows
    uint8_t* wb = (uint8_t*)(la_lane + w * n);  // (kb,) witness carry
    uint8_t* wv = wb + kb;           // (r_cap * n,) witness-valid copy
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_slots = r_cap * n;
    __shared__ int red_max, red_cnt;

    for (int k = threadIdx.x; k < kb; k += blockDim.x) {
        rb[k] = -1;
        lb[k] = -1;
        wb[k] = 0;
    }
    for (int k = threadIdx.x; k < n_slots; k += blockDim.x) wv[k] = wtable[k] >= 0;
    __syncthreads();

    for (int lv = 0; lv < t_lv; ++lv) {
        const int32_t* lrow = levels + (long long)lv * w;
        // phase A: each lane's metadata, la row and parents (one round trip
        // for the metadata and the la row, a second for pre-train parents)
        for (int i = warp; i < w; i += TL_WARPS) {
            const int pos = lrow[i];
            if (pos < 0) {  // padding lane (warp-uniform)
                if (lane == 0) s_p[i] = s_slot[i] = -1;
                continue;
            }
            const int p = min(pos, kb - 1);
            const int sp_p = sp_pos[p], op_p = op_pos[p];
            const int sp_r = sp_row[p], op_r = op_row[p];
            const int fixed = fixed_round[p], c = creator[p];
            for (int q = lane; q < n; q += 32) {
                la_lane[i * n + q] = la_rows[(long long)p * n + q];
            }
            if (lane == 0) {
                const int sp_round = sp_p >= 0 ? rb[min(sp_p, kb - 1)] : tl_pre(rounds, sp_r, e_cap);
                const int op_round = op_p >= 0 ? rb[min(op_p, kb - 1)] : tl_pre(rounds, op_r, e_cap);
                const int sp_lt = sp_p >= 0 ? lb[min(sp_p, kb - 1)] : tl_pre(lamport, sp_r, e_cap);
                const int op_lt = op_p >= 0 ? lb[min(op_p, kb - 1)] : tl_pre(lamport, op_r, e_cap);
                const int pr = max(sp_round, op_round);
                s_p[i] = p;
                s_pr[i] = pr;
                s_spr[i] = sp_round;
                s_lt[i] = (int)((unsigned)max(sp_lt, op_lt) + 1u);
                s_fix[i] = fixed;
                s_c[i] = c;
            }
        }
        __syncthreads();
        // phase C: the strongly-seen counts
        for (int i = warp; i < w; i += TL_WARPS) {
            const int p = s_p[i];
            if (p < 0) continue;  // warp-uniform
            const int pr = s_pr[i];
            const int prc = babble_clamp(pr, 0, r_cap - 1);
            const uint8_t* wv_r = wv + prc * n;
            const bool sees = pr >= 0 && babble_warp_sees_majority(
                la_lane + i * n, fd_cmp + (long long)prc * n * n, n, super_majority,
                [wv_r](int wi) { return wv_r[wi] != 0; });
            if (lane == 0) {
                int rd = pr + (sees ? 1 : 0);
                if (s_fix[i] >= 0) rd = s_fix[i];
                const int wit = rd > s_spr[i];
                const long long slot = (long long)babble_clamp(rd, 0, r_cap - 1) * n + s_c[i];
                s_round[i] = rd;
                s_wit[i] = wit;
                s_slot[i] = (wit && slot >= 0 && slot < n_slots) ? (int)slot : -1;
            }
        }
        __syncthreads();
        // write phase: the carries and the compare copies
        for (int i = threadIdx.x; i < w; i += blockDim.x) {
            const int p = s_p[i];
            if (p < 0) continue;
            rb[p] = s_round[i];
            lb[p] = s_lt[i];
            wb[p] = (uint8_t)s_wit[i];
            if (s_slot[i] >= 0) wv[s_slot[i]] = 1;
        }
        for (int k = threadIdx.x; k < w * n; k += blockDim.x) {
            const int i = k / n, q = k % n;
            const int slot = s_slot[i];
            if (slot < 0) continue;
            fd_cmp[(long long)slot * n + q] = tl_fd_row(fd, rows[s_p[i]], q, n, e_cap);
        }
        __syncthreads();
    }

    // bulk registration (rounds within capacity) and the write-back
    for (int k = threadIdx.x; k < kb; k += blockDim.x) {
        const int r = rows[k];
        if (r < 0) continue;
        const int rd = rb[k];
        const bool in_cap = r < e_cap;
        if (in_cap) {
            rounds[r] = rd;
            lamport[r] = lb[k];
            witness[r] = wb[k];
        }
        if (!wb[k] || rd >= r_cap) continue;
        const long long slot = (long long)babble_clamp(rd, 0, r_cap - 1) * n + creator[k];
        if (in_cap) w_of_row[r] = (int)slot;
        if (slot < 0 || slot >= n_slots) continue;
        wtable[slot] = r;
        idx_w[slot] = index[k];
        coin_w[slot] = coin[k];
    }
    for (int k = warp; k < kb; k += TL_WARPS) {
        const int r = rows[k];
        const int rd = rb[k];
        if (r < 0 || !wb[k] || rd >= r_cap) continue;  // warp-uniform
        const long long slot = (long long)babble_clamp(rd, 0, r_cap - 1) * n + creator[k];
        if (slot < 0 || slot >= n_slots) continue;
        for (int q = lane; q < n; q += 32) {
            la_w[slot * n + q] = la_rows[(long long)k * n + q];
            fd_w[slot * n + q] = tl_fd_row(fd, r, q, n, e_cap);
        }
    }

    if (threadIdx.x == 0) {
        red_max = *last_round;
        red_cnt = 0;
    }
    __syncthreads();
    int m = -1, cnt = 0, late = 0;
    for (int k = threadIdx.x; k < kb; k += blockDim.x) {
        if (rows[k] < 0) continue;
        const int rd = rb[k];
        m = max(m, rd);
        ++cnt;
        late |= wb[k] && rounds_decided[babble_clamp(rd, 0, r_cap - 1)] && rd >= 0
                && rd < r_cap;
    }
    m = __reduce_max_sync(BABBLE_FULL_MASK, m);
    cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
    if (lane == 0) {
        atomicMax(&red_max, m);
        if (cnt) atomicAdd(&red_cnt, cnt);
    }
    late = __syncthreads_or(late);
    if (threadIdx.x == 0) {
        const int lr = red_max;
        *last_round = lr;
        *count = (int)((unsigned)*count + (unsigned)red_cnt);
        if (lr >= r_cap - 1 || late) *stale = 1;
    }
}

__global__ void __launch_bounds__(BABBLE_LEVEL_THREADS)
tl_grid(const int32_t* __restrict__ fd, int32_t* rounds, int32_t* lamport,
        uint8_t* witness, int32_t* wtable, int32_t* w_of_row, int32_t* la_w,
        int32_t* fd_w, int32_t* idx_w, uint8_t* coin_w,
        const uint8_t* __restrict__ rounds_decided, int32_t* last_round,
        int32_t* count, uint8_t* stale,
        const int32_t* __restrict__ rows, const int32_t* __restrict__ creator,
        const int32_t* __restrict__ index, const int32_t* __restrict__ sp_row,
        const int32_t* __restrict__ op_row, const int32_t* __restrict__ sp_pos,
        const int32_t* __restrict__ op_pos, const int32_t* __restrict__ la_rows,
        const uint8_t* __restrict__ coin, const int32_t* __restrict__ fixed_round,
        const int32_t* __restrict__ levels, int32_t* fd_cmp, int32_t* scratch,
        int e_cap, int n, int r_cap, int kb, int w, int super_majority, int aligned16) {
    extern __shared__ int4 tl_smem4[];
    int32_t* tile = reinterpret_cast<int32_t*>(tl_smem4);
    __shared__ const int32_t* a_lane[BABBLE_LT];  // the item's lanes' la rows
    __shared__ int s_pr[BABBLE_LT], s_todo[BABBLE_LT];
    // per lane of the level: c_seen, parent round, self-parent round, new
    // lamport; TL_COUNTERS words (the barrier's count, the last block's
    // ticket, the rows' max round as babble_max_key, their count, the late
    // flag, 1 + the last level), then the carries: rounds_b, lamport_b
    // (kb int32 each), witness_b (kb bytes) and the witness-valid copy
    // (r_cap * n bytes)
    int32_t* c_seen = scratch;
    int32_t* l_pr = c_seen + w;
    int32_t* l_spr = l_pr + w;
    int32_t* l_lt = l_spr + w;
    unsigned int* ctr = reinterpret_cast<unsigned int*>(l_lt + w);
    unsigned int* bar = ctr;
    int32_t* rb = reinterpret_cast<int32_t*>(ctr + TL_COUNTERS);
    int32_t* lb = rb + kb;
    uint8_t* wb = reinterpret_cast<uint8_t*>(lb + kb);
    uint8_t* wv = wb + kb;
    unsigned int bar_target = 0;
    const int lane = threadIdx.x & 31;
    const int n_slots = r_cap * n;
    const int last = (int)__ldcg(ctr + 5) - 1;
    const int n_wt = (n + BABBLE_WT - 1) / BABBLE_WT;
    const int items = (w + BABBLE_LT - 1) / BABBLE_LT * n_wt;
    const int warp_g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int warps_g = (gridDim.x * blockDim.x) >> 5;

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
                    const int p = min(pos, kb - 1);
                    const int sp_p = sp_pos[p], op_p = op_pos[p];
                    const int sp_r = sp_row[p], op_r = op_row[p];
                    const int spr = sp_p >= 0 ? __ldcg(rb + min(sp_p, kb - 1))
                                              : tl_pre(rounds, sp_r, e_cap);
                    const int opr = op_p >= 0 ? __ldcg(rb + min(op_p, kb - 1))
                                              : tl_pre(rounds, op_r, e_cap);
                    pr = max(spr, opr);
                    if (wt == 0) {
                        const int sp_lt = sp_p >= 0 ? __ldcg(lb + min(sp_p, kb - 1))
                                                    : tl_pre(lamport, sp_r, e_cap);
                        const int op_lt = op_p >= 0 ? __ldcg(lb + min(op_p, kb - 1))
                                                    : tl_pre(lamport, op_r, e_cap);
                        __stcg(l_pr + i, pr);
                        __stcg(l_spr + i, spr);
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
                                  return __ldcg(wv + slot) ? fd_cmp + slot * n : nullptr;
                              });
        }
        babble_grid_sync(bar, bar_target);
        // (B) a warp per lane: its results into the carries, and a witness
        // into the compare copies
        for (int i = warp_g; i < w; i += warps_g) {
            const int pos = lrow[i];
            if (pos < 0) continue;  // padding lane (warp-uniform)
            const int p = min(pos, kb - 1);
            int slot = -1;
            if (lane == 0) {
                const int seen = __ldcg(c_seen + i);
                __stcg(c_seen + i, 0);
                int rd = __ldcg(l_pr + i) + (seen >= super_majority ? 1 : 0);
                if (fixed_round[p] >= 0) rd = fixed_round[p];
                const bool wit = rd > __ldcg(l_spr + i);
                __stcg(rb + p, rd);
                __stcg(lb + p, __ldcg(l_lt + i));
                __stcg(wb + p, (uint8_t)wit);
                const long long sl = (long long)babble_clamp(rd, 0, r_cap - 1) * n + creator[p];
                if (wit && sl >= 0 && sl < n_slots) {
                    slot = (int)sl;
                    __stcg(wv + slot, (uint8_t)1);
                }
            }
            slot = __shfl_sync(BABBLE_FULL_MASK, slot, 0);
            if (slot < 0) continue;
            const int row = rows[p];
            int32_t* dst = fd_cmp + (long long)slot * n;
            for (int q = lane; q < n; q += 32) __stcg(dst + q, tl_fd_row(fd, row, q, n, e_cap));
        }
        babble_grid_sync(bar, bar_target);
    }

    // bulk registration (rounds within capacity), the write-back and each
    // block's share of the latches
    int m = -1, cnt = 0, late = 0;
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < kb; k += gridDim.x * blockDim.x) {
        const int r = rows[k];
        if (r < 0) continue;
        const int rd = __ldcg(rb + k);
        const int wk = __ldcg(wb + k);
        const bool in_cap = r < e_cap;
        if (in_cap) {
            rounds[r] = rd;
            lamport[r] = __ldcg(lb + k);
            witness[r] = (uint8_t)wk;
        }
        m = max(m, rd);
        ++cnt;
        late |= wk && rounds_decided[babble_clamp(rd, 0, r_cap - 1)] && rd >= 0 && rd < r_cap;
        if (!wk || rd >= r_cap) continue;
        const long long slot = (long long)babble_clamp(rd, 0, r_cap - 1) * n + creator[k];
        if (in_cap) w_of_row[r] = (int)slot;
        if (slot < 0 || slot >= n_slots) continue;
        wtable[slot] = r;
        idx_w[slot] = index[k];
        coin_w[slot] = coin[k];
    }
    for (int k = warp_g; k < kb; k += warps_g) {
        const int r = rows[k];
        const int rd = __ldcg(rb + k);
        if (r < 0 || !__ldcg(wb + k) || rd >= r_cap) continue;  // warp-uniform
        const long long slot = (long long)babble_clamp(rd, 0, r_cap - 1) * n + creator[k];
        if (slot < 0 || slot >= n_slots) continue;
        for (int q = lane; q < n; q += 32) {
            la_w[slot * n + q] = la_rows[(long long)k * n + q];
            fd_w[slot * n + q] = tl_fd_row(fd, r, q, n, e_cap);
        }
    }
    m = __reduce_max_sync(BABBLE_FULL_MASK, m);
    cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
    late = __reduce_or_sync(BABBLE_FULL_MASK, late);
    if (lane == 0) {
        atomicMax(ctr + 2, babble_max_key(m));
        if (cnt) atomicAdd(ctr + 3, (unsigned)cnt);
        if (late) atomicOr(ctr + 4, 1u);
        __threadfence();
    }
    if (!babble_last_block(ctr + 1)) return;
    if (threadIdx.x == 0) {
        const int lr = max(*last_round, babble_max_of_key(atomicOr(ctr + 2, 0u)));
        *last_round = lr;
        *count = (int)((unsigned)*count + atomicOr(ctr + 3, 0u));
        if (lr >= r_cap - 1 || atomicOr(ctr + 4, 0u)) *stale = 1;
    }
}

extern "C" int babble_train_levels(
    const int32_t* fd, int32_t* rounds, int32_t* lamport, uint8_t* witness,
    int32_t* wtable, int32_t* w_of_row, int32_t* la_w, int32_t* fd_w,
    int32_t* idx_w, uint8_t* coin_w, const uint8_t* rounds_decided,
    int32_t* last_round, int32_t* count, uint8_t* stale, const int32_t* rows,
    const int32_t* creator, const int32_t* index, const int32_t* sp_row,
    const int32_t* op_row, const int32_t* sp_pos, const int32_t* op_pos,
    const int32_t* la_rows, const uint8_t* coin, const int32_t* fixed_round,
    const int32_t* levels, int32_t* fd_cmp, int32_t* scratch,
    int e_cap, int n, int r_cap, int kb, int t_lv, int w, int super_majority,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long total = (long long)r_cap * n * n;
    // the grid walk where the wrapper hands a scratch (tpu/_ext.py
    // train_levels_form chooses), else the one-block walk
    int32_t* rb = nullptr;
    int32_t* last_p1 = nullptr;  // tl_grid's counter word 5
    if (scratch != nullptr) {
        last_p1 = scratch + 4LL * w + 5;
        rb = scratch + 4LL * w + TL_COUNTERS;
        // the per-lane carries and the counters start at 0
        BABBLE_CHECK(cudaMemsetAsync(scratch, 0, ((size_t)4 * w + TL_COUNTERS) * sizeof(int32_t),
                                     s));
    }
    int32_t* lb = rb != nullptr ? rb + kb : nullptr;
    uint8_t* wb = lb != nullptr ? reinterpret_cast<uint8_t*>(lb + kb) : nullptr;
    uint8_t* wv = wb != nullptr ? wb + kb : nullptr;
    const long long lv_total = (long long)t_lv * w;
    long long init_work = total;
    if (scratch != nullptr) {
        const long long most = kb > lv_total ? kb : lv_total;
        init_work = most > init_work ? most : init_work;
    }
    tl_init<<<babble_stride_blocks(init_work, 256), 256, 0, s>>>(
        fd_w, fd_cmp, total, wtable, levels, rb, lb, wb, wv, last_p1, kb, r_cap * n, lv_total, w);
    BABBLE_CHECK_LAUNCH();
    if (scratch == nullptr) {
        const size_t smem = ((size_t)2 * kb + (size_t)9 * w + (size_t)w * n) * sizeof(int32_t)
                            + (size_t)kb + (size_t)r_cap * n;
        BABBLE_CHECK(babble_allow_smem(tl_walk, smem));
        tl_walk<<<1, TL_THREADS, smem, s>>>(
            fd, rounds, lamport, witness, wtable, w_of_row, la_w, fd_w, idx_w,
            coin_w, rounds_decided, last_round, count, stale, rows, creator, index,
            sp_row, op_row, sp_pos, op_pos, la_rows, coin, fixed_round, levels,
            fd_cmp, e_cap, n, r_cap, kb, t_lv, w, super_majority);
        BABBLE_CHECK_LAUNCH();
        return 0;
    }
    const size_t smem = babble_level_item_smem();
    BABBLE_CHECK(babble_allow_smem(tl_grid, smem));
    const long long items =
        (long long)(w + BABBLE_LT - 1) / BABBLE_LT * ((n + BABBLE_WT - 1) / BABBLE_WT);
    int g = 0;
    BABBLE_CHECK(babble_coop_blocks(tl_grid, BABBLE_LEVEL_THREADS, smem, device, items, &g));
    const int aligned16 = babble_rows_aligned16(la_rows, n) && babble_rows_aligned16(fd_cmp, n);
    void* args[] = {
        (void*)&fd, (void*)&rounds, (void*)&lamport, (void*)&witness, (void*)&wtable,
        (void*)&w_of_row, (void*)&la_w, (void*)&fd_w, (void*)&idx_w, (void*)&coin_w,
        (void*)&rounds_decided, (void*)&last_round, (void*)&count, (void*)&stale,
        (void*)&rows, (void*)&creator, (void*)&index, (void*)&sp_row, (void*)&op_row,
        (void*)&sp_pos, (void*)&op_pos, (void*)&la_rows, (void*)&coin, (void*)&fixed_round,
        (void*)&levels, (void*)&fd_cmp, (void*)&scratch, (void*)&e_cap, (void*)&n,
        (void*)&r_cap, (void*)&kb, (void*)&w, (void*)&super_majority, (void*)&aligned16,
    };
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)tl_grid, dim3(g),
                                             dim3(BABBLE_LEVEL_THREADS), args, smem, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}
