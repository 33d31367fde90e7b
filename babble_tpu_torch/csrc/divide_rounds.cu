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
// Exactly as the reference, in both forms: each level reads the carry
// (rounds, lamport, the witness table) as it stood before any write of
// that level, so a parent in the same level or a later one reads the
// initial value (-1); parent indices clamp to E - 1 and a parent outside
// the grid (index < 0) takes its ext_* value; lamport is max + 1 with
// int32 wrap-around; fixed_round >= 0 and fixed_lamport != MIN win; the
// witness-table row clamps to r_max - 1; padding lanes write nothing (the
// reference's dropped scatter); the walk stops after the last level that
// holds an event, since padding rows change nothing.
//
// Bound: the chain of dependent levels, not bytes or operations. The
// function reads each event's metadata and la row once, the witnesses' fd
// rows, and writes the (E,) outputs and the (r_max, N) table: a few MB,
// about a microsecond at 3.35 TB/s; its compares (lanes x witnesses x N per
// level) take a fraction of a millisecond at the ALU rate. But level k+1
// reads what level k wrote, so the levels run in order, and what a level
// costs is its chain of dependent reads. Two forms, chosen by the wrapper
// (tpu/_ext.py walk_form: by width):
//
// dr_staged, narrow levels (below DIVIDE_ROUNDS_GRID_FROM validators): one
// launch of two blocks that walk two independent recurrences, since the
// round recurrence reads no lamport and the lamport recurrence reads no
// round. Block 0 walks rounds, witness flags and the witness table; block 1
// walks lamport with K8's code (common.cuh babble_lamport_walk, its carry
// from -1). Both are common.cuh's staged level walk: the prep launch packs
// every cell of the level table into a record of what the walk reads that
// does not depend on the carry (block 0: the row, the parents clamped to
// E - 1 or -1, their ext rounds, the fixed round, the creator (-1 outside
// [0, N)), the event's la row and its own fd row, each row padded to a
// multiple of 4 with MIN / MAX, which never compare true; block 1:
// babble_lamport_record), and a producer warp bulk-copies the records into
// a ring in shared memory ahead of the consumer warps, so that a level's
// chain is reads of shared memory only. Each block's carry lies in shared
// memory for its first `chip` rows (tpu/_ext.py level_walk_plan: as many
// as fit beside the ring and the window) and in device memory past them
// ("device" carry: chip 0, no window). Block 0's witness table lies in
// device memory, written through; its `win` most recent round rows
// (direct-mapped, round modulo win) lie in shared memory too, as a window:
// per row its round, a bit per creator that holds a witness, and those
// witnesses' fd rows, copied out of the witness's record when a level
// writes it. A round enters the window only when it is written for the
// first time (a bit per round remembers which were), so a round in the
// window holds exactly the table's row: its lookup reads shared memory
// only, a round never written is known empty, any other reads the table
// and the fd rows in device memory, and all give the same integers. Up to
// 8 validators one warp holds the whole level (a lane is a group of
// `group` threads over its parent round's witnesses, a shuffle sum gives
// c_seen; __syncwarp between the phases); up to 32 validators and 31
// lanes a warp per lane (a thread per witness, one warp reduction; a
// named barrier over the consumer warps); the counts stay exact int32.
// Wider levels take the grid walk. One thread writes the level's
// witnesses into the table and the window, in lane order, so that two
// lanes of a level writing one cell leave the later lane's row, as a
// scatter in lane order does. The bound is above; what the design removes
// is the level's chain of dependent loads from device memory, leaving
// reads of shared memory.
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
// The packed layout (babble_tpu/tpu/kernels.py:147-153, packed=True)
// counts the same compares with packed_count and c_seen as the popcount of
// the strongly-seen words: the same integers as these counts, so the
// wrapper launches this kernel for both layouts (counted apart).
//
// Launches per call: the one-block walk two (prep, walk; a memset sets the
// last level to -1 before them), the grid walk three (init, last level,
// walk).

#include "common.cuh"

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

// The words of a record of block 0 (the rounds walk): {row, s, sx, wcr},
// {o, ox, fixed, c}, the la row, the fd row, each row lda = N rounded up
// to a multiple of 4 words. The read phase overwrites s and sx with the
// lane's round and witness flag where a pass's values must wait for the
// write phase, and wcr with the witness-table row it writes (-1: none).
__host__ __device__ __forceinline__ int dr_lda(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int dr_record_words(int n) { return 8 + 2 * dr_lda(n); }

// The lamport walk's and the rounds walk's records of every cell; the
// outputs to their initial values; *last_level (-1 on entry) to the last
// level that holds an event.
__global__ void dr_prep(const int32_t* __restrict__ levels,
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
                        int32_t* rounds, uint8_t* witness, int32_t* lamport, int32_t* wtable,
                        int32_t* last_level, int4* rtable, int4* ltable, long long cells,
                        int n_lvl, int e, int n, long long wt_total) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long k0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long k = k0; k < e; k += stride) {
        rounds[k] = -1;
        lamport[k] = -1;
        witness[k] = 0;
    }
    for (long long k = k0; k < wt_total; k += stride) wtable[k] = -1;
    const int lda = dr_lda(n), quads = dr_record_words(n) / 4;
    int best = -1;
    for (long long k = k0; k < cells * quads; k += stride) {
        const long long cell = k / quads;
        const int q = (int)(k % quads);
        const int row = levels[cell];
        if (q == 0) {
            ltable[cell] = babble_lamport_record(row, self_parent, other_parent, ext_sp_lamport,
                                                 ext_op_lamport, fixed_lamport, e);
            if (row >= 0) best = max(best, (int)(cell / n_lvl));
        }
        if (row < 0) {
            if (q == 0) rtable[k] = make_int4(-1, -1, -1, -1);
            continue;
        }
        const int r = min(row, e - 1);
        int4 v;
        if (q == 0) {
            const int sp = self_parent[r];
            v = make_int4(row, sp >= 0 ? min(sp, e - 1) : -1, ext_sp_round[r], -1);
        } else if (q == 1) {
            const int op = other_parent[r], c = creator[r];
            v = make_int4(op >= 0 ? min(op, e - 1) : -1, ext_op_round[r], fixed_round[r],
                          c >= 0 && c < n ? c : -1);
        } else {
            // la quads pad with MIN, fd quads with MAX: never >= each other
            const bool is_la = q - 2 < lda / 4;
            const int p0 = 4 * (is_la ? q - 2 : q - 2 - lda / 4);
            const int32_t* src = (is_la ? la : fd) + (long long)r * n;
            const int32_t fill = is_la ? BABBLE_MIN_INT32 : BABBLE_MAX_INT32;
            v = make_int4(p0 < n ? src[p0] : fill, p0 + 1 < n ? src[p0 + 1] : fill,
                          p0 + 2 < n ? src[p0 + 2] : fill, p0 + 3 < n ? src[p0 + 3] : fill);
        }
        rtable[k] = v;
    }
    best = __reduce_max_sync(BABBLE_FULL_MASK, best);
    if ((threadIdx.x & 31) == 0 && best >= 0) atomicMax(last_level, best);
}

// Block 0's walk: rounds, witness flags and the witness table.
struct DrRoundWalk {
    const int32_t* last_level;
    int32_t* table;  // (levels, n_lvl) records of dr_record_words(n) words
    const int32_t* fd;
    int32_t* rounds;
    uint8_t* witness;
    int32_t* wtable;
    int n_lvl, e, n, super_majority, r_max;
    int group, warps, chunk, stages, win, chip;
};

// Dynamic shared memory bytes of block 0: the ring (always staged), the
// window's fd rows, round tags and creator bits, the written-round bits,
// the level's witness lanes (one word), the carry's chip rows.
__host__ __device__ __forceinline__ long long dr_round_walk_bytes(const DrRoundWalk& a) {
    const long long nw = (a.n + 31) / 32;
    long long words = (long long)a.win * a.n * dr_lda(a.n) + a.win + a.win * nw;
    if (a.win) words += (a.r_max + 31) / 32;
    words += 1 + a.chip;
    return babble_ring_bytes(a.stages, a.chunk, a.n_lvl * dr_record_words(a.n), 1) + 4 * words;
}

// Block 0's shared memory past the ring.
struct DrWindow {
    int32_t* fd;         // (win, n, lda) the window's fd rows, 16-byte aligned
    int32_t* tag;        // (win,) the round each window row holds, -1: none
    unsigned* bits;      // (win, nw) the creators that hold a witness
    unsigned* written;   // (r_max bits) the rounds ever written
    unsigned* wmask;     // the level's witness lanes (a warp per lane)
};

// One thread writes the level's witnesses into the table (device memory)
// and the window, lanes in order: bit b of `mask` stands for lane b / per
// of the level (per: mask bits a lane). rec: the level's records; each
// witness lane's record holds its row (word 0), its witness-table round
// (word 3, stashed by the read phase), its creator (word 7) and its fd row
// (from word 8 + lda).
__device__ __forceinline__ void dr_write_table(const DrRoundWalk& a, const DrWindow& w,
                                               const int32_t* rec, unsigned mask, int per) {
    const int n = a.n, lda = dr_lda(n), rw = dr_record_words(n), nw = (n + 31) / 32;
    while (mask) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1;
        const int32_t* r = rec + (long long)(b / per) * rw;
        const int row = r[0], cr = r[3], c = r[7];
        a.wtable[(long long)cr * n + c] = row;
        if (!a.win) continue;
        const int slot = cr & (a.win - 1);
        const unsigned bit = 1u << (cr & 31);
        if (w.tag[slot] != cr && !(w.written[cr >> 5] & bit)) {
            // a round never written: its row of the table is all -1
            w.tag[slot] = cr;
            for (int k = 0; k < nw; ++k) w.bits[slot * nw + k] = 0;
        }
        w.written[cr >> 5] |= bit;
        if (w.tag[slot] != cr) continue;
        w.bits[slot * nw + (c >> 5)] |= 1u << (c & 31);
        const int4* src = reinterpret_cast<const int4*>(r + 8 + lda);
        int4* dst = reinterpret_cast<int4*>(w.fd + ((long long)slot * n + c) * lda);
        for (int k = 0; k < lda / 4; ++k) dst[k] = src[k];
    }
}

// A load from device memory that stays where it is written (the window's
// path must not wait on it).
__device__ __forceinline__ int dr_ld_device(const int32_t* p) {
    int v;
    asm volatile("ld.global.cg.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
    return v;
}

// Block 0's walk, in one of two forms of its consumers (tpu/_ext.py
// _round_walk_groups chooses the groups; the launcher the form):
//   LDA 4 or 8: one warp holds the whole level (n <= LDA): a lane is a
//     group of G threads, each over at most four witnesses;
//   LDA 16 or 32: a warp per lane of the level (n <= LDA, at most 31
//     lanes), a thread per witness, c_seen by one warp reduction.
// In both the level is nearly straight-line code and the next level's
// record header is loaded while this one waits on the carry.
template <int LDA>
__device__ __forceinline__ void dr_round_walk(const DrRoundWalk& a, unsigned char* smem) {
    const int n = a.n, lda = dr_lda(n), rw = dr_record_words(n), nw = (n + 31) / 32;
    const int n_lvl = a.n_lvl, lw = n_lvl * rw;
    BabbleRing ring{nullptr, nullptr, nullptr, a.table, a.stages, a.chunk, lw,
                    *a.last_level + 1};
    int32_t* p = babble_ring_carve(ring, smem, 1);
    DrWindow win;
    win.fd = p;
    p += (long long)a.win * n * lda;
    win.tag = p;
    p += a.win;
    win.bits = reinterpret_cast<unsigned*>(p);
    p += a.win * nw;
    win.written = reinterpret_cast<unsigned*>(p);
    p += a.win ? (a.r_max + 31) / 32 : 0;
    win.wmask = reinterpret_cast<unsigned*>(p);
    p += 1;
    const BabbleSplit rounds{p, a.rounds, a.chip};
    for (int k = threadIdx.x; k < a.chip; k += blockDim.x) p[k] = -1;
    for (int k = threadIdx.x; k < a.win; k += blockDim.x) win.tag[k] = -1;
    if (a.win) {
        for (int k = threadIdx.x; k < (a.r_max + 31) / 32; k += blockDim.x) win.written[k] = 0;
    }
    if (threadIdx.x == 0) win.wmask[0] = 0;
    babble_ring_init(ring, a.warps);
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    if (warp == 0) {
        babble_ring_produce(ring);
    } else if (warp <= a.warps) {
        const int G = a.group, t = threadIdx.x - 32, lane = threadIdx.x & 31;
        const int gi = t / G, gl = t % G, cw = t >> 5;
        const int sm = a.super_majority;
        // whether the window holds clamped round cr (hit), or knows that
        // it was never written, so that its row of the table is all -1
        auto lookup = [&](int cr, int& slot, bool& hit) -> bool {
            slot = a.win ? (cr & (a.win - 1)) : 0;
            hit = a.win && win.tag[slot] == cr;
            return a.win && !hit && !((win.written[cr >> 5] >> (cr & 31)) & 1u);
        };
        // whether the window holds witness w of the round it holds in
        // `slot`; the count of la(q) >= its fd row (padded with MAX to lda)
        auto window_has = [&](int slot, int w) -> bool {
            return (win.bits[slot * nw + (w >> 5)] >> (w & 31)) & 1u;
        };
        // the table's witness w of clamped round cr (-1: none), read on a
        // miss only, by a load the compiler may not hoist onto the
        // window's path
        auto table_row = [&](int cr, int w) -> int {
            return dr_ld_device(a.wtable + (long long)cr * n + w);
        };
        babble_ring_consume<true>(ring, [&](int32_t* base, int, int nl) {
            if constexpr (LDA == 4 || LDA == 8) {
                // one warp: lane gi's record in each level
                constexpr int RW = 8 + 2 * LDA;
                const bool act = gi < n_lvl;
                int32_t* rec = base + gi * RW;
                int4 h0 = make_int4(-1, -1, -1, -1), h1 = make_int4(0, 0, -1, -1);
                int la_e[LDA];
                auto load = [&](const int32_t* r) {
                    if (!act) return;
                    h0 = *reinterpret_cast<const int4*>(r);
                    h1 = *reinterpret_cast<const int4*>(r + 4);
#pragma unroll
                    for (int q = 0; q < LDA / 4; ++q) {
                        const int4 v = reinterpret_cast<const int4*>(r + 8)[q];
                        la_e[4 * q] = v.x;
                        la_e[4 * q + 1] = v.y;
                        la_e[4 * q + 2] = v.z;
                        la_e[4 * q + 3] = v.w;
                    }
                };
                load(rec);
                for (int j = 0; j < nl; ++j) {
                    int32_t* r = rec + (long long)j * lw;
                    const int4 c0 = h0, c1 = h1;
                    int la_c[LDA];
#pragma unroll
                    for (int q = 0; q < LDA; ++q) la_c[q] = la_e[q];
                    if (j + 1 < nl) load(r + lw);
                    // read phase (a padding lane's record holds its row alone)
                    const int row = c0.x;
                    const int spr = rounds.parent(c0.y, c0.z);
                    const int pr = max(spr, rounds.parent(row >= 0 ? c1.x : -1, c1.y));
                    const bool counts = row >= 0 && pr >= 0;
                    // the window's row of the lane's clamped parent round:
                    // its tag, the bits, and the fd rows of this thread's
                    // witnesses (at most four) are loaded together
                    const int cr = min(max(pr, 0), a.r_max - 1);
                    const int slot = a.win ? (cr & (a.win - 1)) : 0;
                    int4 fw[4][LDA / 4];
                    unsigned bits = 0;
                    bool hit = false, blank = false;
                    if (a.win) {
                        hit = win.tag[slot] == cr;
                        blank = !((win.written[cr >> 5] >> (cr & 31)) & 1u);
                        bits = win.bits[slot];
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            const int w = gl + k * G;
                            if (w < n) {
                                const int4* f4 = reinterpret_cast<const int4*>(
                                    win.fd + ((long long)slot * n + w) * LDA);
#pragma unroll
                                for (int q = 0; q < LDA / 4; ++q) fw[k][q] = f4[q];
                            }
                        }
                    }
                    int seen = 0;
                    if (counts && hit) {
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            const int w = gl + k * G;
                            int cnt = 0;
#pragma unroll
                            for (int q = 0; q < LDA / 4; ++q) {
                                const int4 y = fw[k][q];
                                cnt += (la_c[4 * q] >= y.x) + (la_c[4 * q + 1] >= y.y)
                                       + (la_c[4 * q + 2] >= y.z) + (la_c[4 * q + 3] >= y.w);
                            }
                            seen += w < n && ((bits >> w) & 1u) && cnt >= sm;
                        }
                    } else if (counts && !blank) {
                        // a round outside the window: the table and the fd
                        // rows in device memory
                        for (int w = gl; w < n; w += G) {
                            const int wr = table_row(cr, w);
                            if (wr < 0) continue;
                            const int32_t* f = a.fd + (long long)min(wr, a.e - 1) * n;
                            int cnt = 0;
#pragma unroll
                            for (int q = 0; q < LDA; ++q) {
                                if (q < n) cnt += la_c[q] >= dr_ld_device(f + q);
                            }
                            seen += cnt >= sm;
                        }
                    }
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1) {
                        if (off < G) seen += __shfl_xor_sync(BABBLE_FULL_MASK, seen, off);
                    }
                    int rd = pr + (seen >= sm ? 1 : 0);
                    if (c1.z >= 0) rd = c1.z;  // fixed round
                    const int wit = rd > spr;
                    const int wcr =
                        row >= 0 && wit && c1.w >= 0 ? babble_clamp(rd, 0, a.r_max - 1) : -1;
                    if (gl == 0 && act) r[3] = wcr;
                    const unsigned mask = __ballot_sync(BABBLE_FULL_MASK, gl == 0 && wcr >= 0);
                    __syncwarp();
                    // write phase; padding lanes write nothing
                    if (gl == 0 && row >= 0) {
                        rounds.st(row, rd);
                        a.witness[row] = (uint8_t)wit;
                    }
                    if (t == 0 && mask) dr_write_table(a, win, r - gi * RW, mask, G);
                    __syncwarp();
                }
            } else if constexpr (LDA == 16 || LDA == 32) {
                // a warp per lane (cw), a thread per witness (lane); the
                // records' rows are lda <= LDA words
                const bool act = cw < n_lvl;
                int32_t* rec = base + cw * rw;
                int4 h0 = make_int4(-1, -1, -1, -1), h1 = make_int4(0, 0, -1, -1);
                auto load = [&](const int32_t* r) {
                    if (!act) return;
                    h0 = *reinterpret_cast<const int4*>(r);
                    h1 = *reinterpret_cast<const int4*>(r + 4);
                };
                load(rec);
                for (int j = 0; j < nl; ++j) {
                    int32_t* r = rec + (long long)j * lw;
                    const int4 c0 = h0, c1 = h1;
                    if (j + 1 < nl) load(r + lw);
                    const int row = c0.x;
                    const int spr = rounds.parent(c0.y, c0.z);
                    const int pr = max(spr, rounds.parent(row >= 0 ? c1.x : -1, c1.y));
                    const bool counts = row >= 0 && pr >= 0;
                    const int cr = min(max(pr, 0), a.r_max - 1);
                    int slot;
                    bool hit;
                    const bool blank = lookup(cr, slot, hit);
                    bool ok = false;
                    int cnt = 0;
                    if (counts && !blank && lane < n) {
                        if (hit) {
                            ok = window_has(slot, lane);
                            if (ok) {
                                const int4* la4 = reinterpret_cast<const int4*>(r + 8);
                                const int4* f4 = reinterpret_cast<const int4*>(
                                    win.fd + ((long long)slot * n + lane) * lda);
#pragma unroll
                                for (int q = 0; q < LDA / 4; ++q) {
                                    if (4 * q >= lda) break;
                                    const int4 x = la4[q], y = f4[q];
                                    cnt += (x.x >= y.x) + (x.y >= y.y) + (x.z >= y.z)
                                           + (x.w >= y.w);
                                }
                            }
                        } else {
                            const int wr = table_row(cr, lane);
                            ok = wr >= 0;
                            if (ok) {
                                const int32_t* f = a.fd + (long long)min(wr, a.e - 1) * n;
                                for (int q = 0; q < n; ++q) cnt += r[8 + q] >= dr_ld_device(f + q);
                            }
                        }
                    }
                    const int seen = __reduce_add_sync(BABBLE_FULL_MASK, ok && cnt >= sm);
                    int rd = pr + (seen >= sm ? 1 : 0);
                    if (c1.z >= 0) rd = c1.z;  // fixed round
                    const int wit = rd > spr;
                    const int wcr =
                        row >= 0 && wit && c1.w >= 0 ? babble_clamp(rd, 0, a.r_max - 1) : -1;
                    if (lane == 0 && act) {
                        r[3] = wcr;
                        if (wcr >= 0) atomicOr(win.wmask, 1u << cw);
                    }
                    babble_consumer_sync(a.warps);
                    if (lane == 0 && row >= 0) {
                        rounds.st(row, rd);
                        a.witness[row] = (uint8_t)wit;
                    }
                    if (t == 0) {
                        const unsigned mask = win.wmask[0];  // the witness lanes
                        if (mask) {
                            dr_write_table(a, win, r - cw * rw, mask, 1);
                            win.wmask[0] = 0;
                        }
                    }
                    babble_consumer_sync(a.warps);
                }
            }
        });
    }
    __syncthreads();
    for (int k = threadIdx.x; k < a.chip; k += blockDim.x) a.rounds[k] = p[k];
}

// The one-warp forms launch WALK_MIN_THREADS (256) threads, which leaves
// their level code more registers.
template <int LDA, bool LAM_ONE>
__global__ void __launch_bounds__(LDA == 4 || LDA == 8 ? 256 : 1024)
    dr_staged(DrRoundWalk rounds, BabbleLamWalk lamport) {
    extern __shared__ int4 dr_staged_smem[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(dr_staged_smem);
    if (blockIdx.x == 0) dr_round_walk<LDA>(rounds, smem);
    else babble_lamport_walk<LAM_ONE>(lamport, smem);
}

template <int LDA, bool LAM_ONE>
static inline cudaError_t dr_staged_launch(const DrRoundWalk& rw, const BabbleLamWalk& lw,
                                         int threads, size_t smem, cudaStream_t s) {
    cudaError_t err = babble_allow_smem(dr_staged<LDA, LAM_ONE>, smem);
    if (err != cudaSuccess) return err;
    dr_staged<LDA, LAM_ONE><<<2, threads, smem, s>>>(rw, lw);
    return cudaGetLastError();
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
    int32_t* last_level, int32_t* scratch, int32_t* rtable, int32_t* ltable,
    int l_lv, int n_lvl, int e, int n, int super_majority, int r_max,
    int group, int warps, int lam_warps, int chunk, int lam_chunk, int stages,
    int lam_staged, int win, int chip, int lam_chip, int threads,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long wt_total = (long long)r_max * n;
    long long lv_total = (long long)l_lv * n_lvl;
    if (scratch == nullptr) {
        // the one-block walk (tpu/_ext.py level_walk_plan sizes it)
        BABBLE_CHECK(cudaMemsetAsync(last_level, 0xff, sizeof(int32_t), s));
        const long long work = lv_total * (dr_record_words(n) / 4);
        const long long big = work > e ? (work > wt_total ? work : wt_total)
                                       : (e > wt_total ? e : wt_total);
        dr_prep<<<babble_stride_blocks(big > 0 ? big : 1, 256), 256, 0, s>>>(
            levels, creator, self_parent, other_parent, la, fd, ext_sp_round, ext_op_round,
            fixed_round, ext_sp_lamport, ext_op_lamport, fixed_lamport, rounds, witness,
            lamport, wtable, last_level, reinterpret_cast<int4*>(rtable),
            reinterpret_cast<int4*>(ltable), lv_total, n_lvl, e, n, wt_total);
        BABBLE_CHECK_LAUNCH();
        const DrRoundWalk rw{last_level, rtable, fd, rounds, witness, wtable, n_lvl, e, n,
                             super_majority, r_max, group, warps, chunk, stages, win, chip};
        const BabbleLamWalk lw{last_level, ltable, lamport, n_lvl, -1, lam_warps, lam_chunk,
                               stages, lam_staged, lam_chip};
        const long long b0 = dr_round_walk_bytes(rw), b1 = babble_lamport_walk_bytes(lw);
        const long long smem = b0 > b1 ? b0 : b1;
        if (smem > 232448 || threads > 1024 || threads < 32 * (1 + (warps > lam_warps ? warps : lam_warps))) {
            return (int)cudaErrorInvalidValue;
        }
        // block 0's form (dr_round_walk) and K8's one-pass form
        int lda = 0;
        if (warps == 1 && n <= 8 && threads <= 256) lda = n <= 4 ? 4 : 8;
        else if (group == 32 && n <= 32 && n_lvl <= warps) lda = n <= 16 ? 16 : 32;
        if (lda == 0) return (int)cudaErrorInvalidValue;  // the grid walk's widths
        const bool one = n_lvl <= 32 * lam_warps;
        const size_t sm = (size_t)smem;
        cudaError_t err;
        if (lda == 4) {
            err = one ? dr_staged_launch<4, true>(rw, lw, threads, sm, s)
                      : dr_staged_launch<4, false>(rw, lw, threads, sm, s);
        } else if (lda == 8) {
            err = one ? dr_staged_launch<8, true>(rw, lw, threads, sm, s)
                      : dr_staged_launch<8, false>(rw, lw, threads, sm, s);
        } else if (lda == 16) {
            err = one ? dr_staged_launch<16, true>(rw, lw, threads, sm, s)
                      : dr_staged_launch<16, false>(rw, lw, threads, sm, s);
        } else {
            err = one ? dr_staged_launch<32, true>(rw, lw, threads, sm, s)
                      : dr_staged_launch<32, false>(rw, lw, threads, sm, s);
        }
        BABBLE_CHECK(err);
        return 0;
    }
    long long work = wt_total > e ? wt_total : e;
    dr_init<<<babble_stride_blocks(work, 256), 256, 0, s>>>(
        rounds, lamport, witness, wtable, last_level, scratch, e, wt_total, n_lvl);
    BABBLE_CHECK_LAUNCH();
    if (lv_total > 0) {
        babble_last_level<<<babble_stride_blocks(lv_total, 256), 256, 0, s>>>(
            levels, last_level, lv_total, n_lvl);
        BABBLE_CHECK_LAUNCH();
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
