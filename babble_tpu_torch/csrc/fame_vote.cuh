// The virtual vote of one round's witness columns, shared by K3
// (decide_fame.cu, both voting-table layouts) and B21's one-card form
// (shard_fame.cu, shard_fame/grid).
//
// Hashgraph's DecideFame (reference hashgraph.go:852-947, JAX
// babble_tpu/tpu/kernels.py:234-326) votes on every witness x of round i
// with the witnesses y of round j = i + d, d = 2, 3, ...:
//   yays[y] = |{w : y strongly sees w (round j - 1) and w voted yes}|,
//   nays[y] = total[y] - yays[y], v = yays >= nays,
//   strong  = max(yays, nays) >= super_majority;
// a non-coin step's first strong verdict of a valid voter decides x
// (famous = any such verdict is yes); the next votes are v, or on a coin
// step (d % n_participants == 0) v where strong, else the voter's coin bit.
// yays[y] reads column x of the votes alone, decided[x] is sticky and the
// next column x comes from column x alone: every (round, column) evolves on
// its own, and may stop at its own first decision or at its own last step
// (i + d > last_round, d > d_cap) with the bits of the reference's global
// any(active) exit. So no step needs a barrier across columns.
//
// One block takes one round i and FV_COLS consecutive columns x; warp
// 1 + c owns column x0 + c. The column's votes are bit words, bit t of
// word k for voter 32 k + t. Up to FV_REG_WORDS words (1,024 validators)
// they live in registers, a copy of every word in every lane (WMAX >=
// words): lanes run over the voters y, yays = sum_k popc(ss[y][k] &
// col[k]), and each step's new words come from __ballot_sync, which hands
// every lane the same word; lane b keeps word b until the step ends, and
// the copies are rebuilt from it by shuffles. Past that (WMAX = 0) the
// warp keeps two buffers of the column's words in shared memory, the
// step's votes read from one (every lane the same word: a broadcast) and
// the new words written to the other by lane 0, swapped at the step's end;
// the ring then takes as many slots as fit beside them (at least two:
// fv_stages, up to FV_SMEM_MAX). decided and famous stay in registers.
//
// The strongly-see planes do not depend on the votes, so warp 0 fetches
// them ahead: one lane bulk-copies (cp.async.bulk, counted on the slot's
// `full` mbarrier) the block's items in order, step after step, into a
// ring of FV_STAGES slots, and waits on the slot's `empty` mbarrier (one
// arrival per consumer warp) before it refills it. An item is rows_item
// voter rows of one plane, at row stride ldw = words | 1 (odd: lanes over
// rows hit distinct banks), and their aux words (total * 4 + coin * 2 +
// voter valid, so that total[y] is counted once per plane, where the plane
// is built). A warp whose column has stopped keeps releasing the slots it
// passes without reading them, so the ring never waits on it; when no
// column of the block is left the producer stops early and marks the item
// it did not fetch (stop_at), which ends every consumer's loop there.
//
// Bound: the planes are read from L2 once per block and step; the tally is
// words popcounts per voter per step, far below the card's integer rate.

#pragma once

#include <type_traits>

#include "common.cuh"

#define FV_COLS 16
#define FV_THREADS (32 * (FV_COLS + 1))
#define FV_STAGES 8
#define FV_REG_WORDS 32
#define FV_SMEM_MAX 232448  // one block's dynamic shared memory on sm_90

// The voting tables in device memory: `planes` planes of n_pad = 32 words
// voter rows, ss at row stride ldw words, aux one int32 a row; the ring's
// slots (fv_stages).
struct FameTables {
    const uint32_t* ss;
    const int32_t* aux;
    int words, ldw, n_pad, rows_item, items, stages;
};

__host__ __device__ __forceinline__ int fv_ldw(int words) { return words | 1; }

// The ring's item: a group of voter blocks of 32 rows (about 1,024 words of
// ss), and the items of one step.
__host__ __device__ __forceinline__ int fv_group(int words) {
    int g = 32 / fv_ldw(words);
    if (g < 1) g = 1;
    return g < words ? g : words;
}

// Dynamic shared memory of one voting block apart from the ring's slots:
// the mbarriers, two control words (live columns, stop_at) padded to 16
// bytes and, past FV_REG_WORDS, each column's two buffers of words; and
// one slot (its ss rows and aux words).
__host__ __device__ __forceinline__ long long fv_fixed_bytes(int words) {
    return 16LL * FV_STAGES + 16 + (words > FV_REG_WORDS ? 8LL * FV_COLS * words : 0);
}

__host__ __device__ __forceinline__ long long fv_slot_bytes(int words) {
    return 4LL * 32 * fv_group(words) * (fv_ldw(words) + 1);
}

// The ring's slots: FV_STAGES up to FV_REG_WORDS, past it as many as fit
// FV_SMEM_MAX, at most FV_STAGES; fewer than 2 (past 603 words) and the
// vote cannot run.
__host__ __device__ __forceinline__ int fv_stages(int words) {
    if (words <= FV_REG_WORDS) return FV_STAGES;
    const long long s = (FV_SMEM_MAX - fv_fixed_bytes(words)) / fv_slot_bytes(words);
    return s < 2 ? 0 : (s > FV_STAGES ? FV_STAGES : (int)s);
}

__host__ __device__ __forceinline__ FameTables fv_tables(const uint32_t* ss, const int32_t* aux,
                                                        int words) {
    FameTables t;
    t.ss = ss;
    t.aux = aux;
    t.words = words;
    t.ldw = fv_ldw(words);
    t.n_pad = 32 * words;
    t.rows_item = 32 * fv_group(words);
    t.items = (words + fv_group(words) - 1) / fv_group(words);
    t.stages = fv_stages(words);
    return t;
}

// Dynamic shared memory of one voting block: fv_fixed_bytes, then the ss
// slots, the aux slots and the column buffers.
__host__ __device__ __forceinline__ long long fv_smem_bytes(int words) {
    return fv_fixed_bytes(words) + fv_stages(words) * fv_slot_bytes(words);
}

__device__ __forceinline__ void fv_mbar_inval(uint64_t* bar) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(babble_smem_u32(bar))
                 : "memory");
}

// Generic-proxy writes to global memory made visible to later bulk copies
// (the async proxy) that read them.
__device__ __forceinline__ void fv_fence_proxy_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

struct FvColumn {
    bool valid, decided, famous;
};

// One (round i, columns x0 .. x0 + FV_COLS - 1) task, every thread of the
// block; steps d = 2 .. d_end. Src (the caller's layout) gives
//   n_cols, valid(i, x), plane(i, d) (the plane of round i's voters at
//   step d), col0(i, x, k) (word k of column x's d = 1 votes), done(i, x,
//   decided, famous) (lane 0 of the column's warp writes).
// Returns the column's state in the consumer warps (valid false past
// n_cols and in warp 0). A task with steps syncs the block on entry and
// before it returns, after which the mbarriers are invalidated, so that a
// persistent block may run the next task; one without (d_end < 2) only
// writes its columns.
template <int WMAX, typename Src>
__device__ __forceinline__ FvColumn fame_task(const Src& src, const FameTables& t, int i,
                                              int x0, int d_end, int n_participants,
                                              int super_majority, unsigned char* smem) {
    constexpr bool REG = WMAX > 0;  // the column's words in registers
    const int stages = REG ? FV_STAGES : t.stages;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + FV_STAGES;
    int* ctl = reinterpret_cast<int*>(empty + FV_STAGES);  // live columns, stop_at
    uint32_t* slots = reinterpret_cast<uint32_t*>(ctl + 4);
    const int slot_words = t.rows_item * t.ldw;
    int32_t* aux_slots = reinterpret_cast<int32_t*>(slots + stages * slot_words);
    // past FV_REG_WORDS: two buffers of each column's words
    uint32_t* col_bufs = reinterpret_cast<uint32_t*>(aux_slots + stages * t.rows_item);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int x = x0 + warp - 1;

    FvColumn st{false, false, false};
    if (warp > 0 && x < src.n_cols) st.valid = src.valid(i, x);
    if (d_end < 2) {
        // no step: nothing is decided, and no barrier is needed
        if (warp > 0 && x < src.n_cols && lane == 0) src.done(i, x, false, false);
        return st;
    }
    bool running = st.valid;
    if (threadIdx.x == 0) {
        for (int s = 0; s < FV_STAGES; ++s) {
            babble_mbar_init(full + s, 1);
            babble_mbar_init(empty + s, FV_COLS);
        }
        babble_mbar_init_fence();
        ctl[1] = -1;
    }
    const int live = __syncthreads_count(running && lane == 0);
    if (threadIdx.x == 0) ctl[0] = live;
    __syncthreads();
    const int total = live > 0 ? (d_end - 1) * t.items : 0;

    if (warp == 0) {
        for (int k = 0; k < total; ++k) {
            const int s = k % stages;
            if (k >= stages) babble_mbar_wait(empty + s, ((k / stages) - 1) & 1);
            int go = lane == 0 ? *(volatile int*)ctl > 0 : 0;
            go = __shfl_sync(BABBLE_FULL_MASK, go, 0);
            if (!go) {
                // no column left: mark the item not fetched, wake its waiters
                if (lane == 0) {
                    *(volatile int*)(ctl + 1) = k;
                    babble_mbar_arrive(full + s);
                }
                break;
            }
            if (lane == 0) {
                const int d = 2 + k / t.items;
                const int r0 = (k % t.items) * t.rows_item;
                const int rows = min(t.rows_item, t.n_pad - r0);
                const long long row0 = (long long)src.plane(i, d) * t.n_pad + r0;
                const unsigned b_ss = (unsigned)rows * (unsigned)t.ldw * 4u;
                babble_mbar_expect_tx(full + s, b_ss + 4u * (unsigned)rows);
                babble_bulk_load(slots + s * slot_words, t.ss + row0 * t.ldw, b_ss, full + s);
                babble_bulk_load(aux_slots + s * t.rows_item, t.aux + row0, 4u * rows, full + s);
            }
            __syncwarp();
        }
    } else {
        uint32_t col[REG ? WMAX : 1];
        uint32_t mine = 0u;
        uint32_t* cb = col_bufs + (warp - 1) * 2 * t.words;  // WMAX = 0: buffers par, par ^ 1
        int par = 0;
        if (REG) {
            mine = running && lane < t.words ? src.col0(i, x, lane) : 0u;
#pragma unroll
            for (int q = 0; q < WMAX; ++q) col[q] = __shfl_sync(BABBLE_FULL_MASK, mine, q);
        } else {
            for (int q = lane; q < t.words; q += 32) cb[q] = running ? src.col0(i, x, q) : 0u;
            __syncwarp();
        }
        unsigned any_dn = 0, any_dv = 0;
        const int blocks_item = t.rows_item / 32;
        for (int k = 0; k < total; ++k) {
            const int s = k % stages;
            babble_mbar_wait(full + s, (k / stages) & 1);
            if (*(volatile int*)(ctl + 1) == k) break;
            const int c = k % t.items;
            if (running) {
                const int d = 2 + k / t.items;
                const bool is_coin = (d % n_participants) == 0;
                const uint32_t* ss_s = slots + s * slot_words;
                const int32_t* ax_s = aux_slots + s * t.rows_item;
                const int vb0 = c * blocks_item;
                const int vb1 = min(vb0 + blocks_item, t.words);
                for (int vb = vb0; vb < vb1; ++vb) {
                    const int r = (vb - vb0) * 32 + lane;
                    const uint32_t* row = ss_s + r * t.ldw;
                    int ya = 0;
                    if (REG) {
#pragma unroll
                        for (int q = 0; q < (REG ? WMAX : 1); ++q) {
                            if (q < t.words) ya += __popc(row[q] & col[q]);
                        }
                    } else {
                        const uint32_t* cur = cb + par * t.words;
#pragma unroll 4
                        for (int q = 0; q < t.words; ++q) ya += __popc(row[q] & cur[q]);
                    }
                    const int ax = ax_s[r];
                    const int nays = (ax >> 2) - ya;
                    const bool v = ya >= nays;
                    const bool strong = (v ? ya : nays) >= super_majority;
                    const bool nv = is_coin ? (strong ? v : ((ax >> 1) & 1) != 0) : v;
                    const bool dn = !is_coin && strong && (ax & 1);
                    const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, nv);
                    if (REG && lane == vb) mine = bits;
                    if (!REG && lane == 0) cb[(par ^ 1) * t.words + vb] = bits;
                    any_dn |= __ballot_sync(BABBLE_FULL_MASK, dn);
                    any_dv |= __ballot_sync(BABBLE_FULL_MASK, dn && v);
                }
                if (c == t.items - 1) {
                    if (any_dn) {
                        st.decided = true;
                        st.famous = any_dv != 0;
                        running = false;
                        if (lane == 0) atomicSub(ctl, 1);
                    } else if (REG) {
#pragma unroll
                        for (int q = 0; q < (REG ? WMAX : 1); ++q) {
                            col[q] = __shfl_sync(BABBLE_FULL_MASK, mine, q);
                        }
                    } else {
                        __syncwarp();  // the new words written, the old ones read
                        par ^= 1;
                    }
                    any_dn = any_dv = 0;
                }
            }
            __syncwarp();
            if (lane == 0) babble_mbar_arrive(empty + s);
        }
        if (x < src.n_cols && lane == 0) src.done(i, x, st.decided, st.famous);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int s = 0; s < FV_STAGES; ++s) {
            fv_mbar_inval(full + s);
            fv_mbar_inval(empty + s);
        }
    }
    return st;
}

// Launch kern<WMAX> for the least WMAX in {1, 2, 4, 8, 16, 32} that holds
// `words`, else kern<0> (the words in shared memory) where its ring fits:
// `launch` is a generic lambda taking an integral constant.
template <typename Launch>
static inline int fv_dispatch(int words, Launch launch) {
    if (words <= 1) return launch(std::integral_constant<int, 1>());
    if (words <= 2) return launch(std::integral_constant<int, 2>());
    if (words <= 4) return launch(std::integral_constant<int, 4>());
    if (words <= 8) return launch(std::integral_constant<int, 8>());
    if (words <= 16) return launch(std::integral_constant<int, 16>());
    if (words <= 32) return launch(std::integral_constant<int, 32>());
    if (fv_stages(words) >= 2) return launch(std::integral_constant<int, 0>());
    return (int)cudaErrorInvalidValue;
}
