// decide_window: windowed fame and round received of the incremental engine.
//
// Replaces babble_tpu/tpu/incremental.py:361 _decide_body with :125
// _fame_window. In place, over the state's dense per-witness buffers:
//   floor_true = the first round <= last_round not yet decided (last_round
//                if none); floor = clip(floor_true, 0, R_cap - r_win)
//   fame over the window of r_win rounds from floor, with the voting
//   offsets d = 2 .. d_unroll + 1 and no early exit:
//     ss[j, y, w]     = |{q : la_w[j, y, q] >= fd_w[j-1, w, q]}| >= sm, both
//                       witnesses present (no round below the window)
//     votes0[i, y, x] = la_w[i+1, y, x] >= idx_w[i, x], y present (none
//                       above the window)
//     per d: voters j = i + d must lie in the window and <= last_round;
//     yays = sum_w ss[j, y, w] votes[w, x], nays = total - yays; a coin step
//     (d % n_participants == 0) takes the voter's coin bit where not strong,
//     any other step decides x where a strong voter exists, first decision
//     wins;
//   rows of the window below floor_true keep their stored fame (the
//   freeze); fame_lag latches witnesses left undecided with voters beyond
//   the unroll, or a window whose top is below last_round;
//   round received over rows [lo, lo + e_win), lo = clip(count - e_win, 0,
//   E_cap - e_win), for the occupied rows still undetermined, with the
//   reference's clamps (famous-witness minima capped at 2^24, the horizon
//   at R_cap); stale latches an undetermined occupied row below lo.
// The reference's fp32 vote einsum and one-hot matmuls give exact
// integers; here the tally is a popcount of bit rows (32 voters or
// witnesses to a word), and the lookups are integer loads.
//
// Bound: operations at 1,024 validators (the strongly-see compares,
// r_win x N^3, and the eight offsets' tallies, 8 x r_win x N^2 x N / 32
// words), bytes below that (the window's la_w / fd_w rows and the e_win
// rows' index / creator / rounds / received). Four launches, each over
// the whole card, with shared memory that does not grow with N:
//   dw_setup, a block per (window round j, tile of 64 rows y, tile of 64
//     witnesses w): the compare-count tile (common.cuh
//     babble_count_ge_tile: la_w[j] rows y against fd_w[j-1] rows w, the
//     coordinates through shared memory by cp.async, a 4 x 4 register tile
//     per thread) gives the tile's ss bit words by ballot; a tile with no
//     present pair writes zeros without counting. The same block writes
//     the d = 1 vote words of columns x = its witness tile, voters y = its
//     row tile (la_w[j+1] read coalesced, turned by a shared tile).
//   dw_vote, a block per (window round i, 32 columns x): vote column x of
//     offset d depends only on column x of offset d - 1 and on the voting
//     round's ss rows, and so do decided[x] and famous[x]. Per offset the
//     block streams the ss rows of round i + d, 64 rows y x 32 words at a
//     time, with its columns' vote words, through a ring of two shared
//     tiles (cp.async), each thread holding a 2 x 4 tile of (y, x) tallies;
//     the next offset's vote words go back to a global buffer (two, in
//     turn; each block owns its columns). It stops at the first offset
//     whose voters lie above last_round or the window, or once every
//     column is decided or absent: nothing after that changes an output.
//     A round's rounds_decided needs all its column blocks: each adds its
//     verdicts into per-round counts, and the last block to finish (a
//     ticket) writes it. The freeze keeps a settled round's stored values.
//   dw_tables, a block per (round, 128 columns c): the famous-witness
//     count, the min over famous witnesses of la_w[r, w, c] (only the
//     famous ones are read: common.cuh babble_famous_min, the set-bit
//     walk K4 and B23 take too), and whether r is decided.
//   dw_events, a grid over all E_cap rows: received in the window, the
//     stale detector below it (the horizon scanned in shared memory).
// Where the caller passes a vector (`pack`), the last two launches also
// write K13 pack_results' layout of what the live engine's write-back
// reads (replacing babble_tpu/tpu/live.py:757 _pack_results for a fetch
// that follows a decide; pack_results.cu stays for one that does not):
// dw_tables, after the vote, the three (r_cap, n) tables (a thread its
// column of its round) and the scalars as they stand (stale, fame_lag,
// last_round); dw_events each row's four words, received after its own
// update, and a 1 into the stale word wherever it latches stale, so the
// word ends as stale does.
//
// Both voting-table layouts launch this kernel: its tallies are bit words
// already, so the packed layout (tpu/packed.py) has nothing to change.

#include "common.cuh"

#define DW_FD_CLAMP (1 << 24)
// dw_setup: 64 x 64 (y, w) pairs a block, a 4 x 4 register tile a thread
#define DW_ST 64
#define DW_SETUP_THREADS 256
#define DW_SETUP_STAGES 3
// dw_vote: XT columns x a block, YC rows y and KC words a stage
#define DW_XT 32
#define DW_YC 64
#define DW_KC_MAX 32
#define DW_VOTE_THREADS 256
#define DW_VOTE_LD 36  // the widest stage's row stride (KC 32)

// floor_true and floor from the rounds_decided table as it stands
__device__ void dw_floor(const uint8_t* rounds_decided, int lr, int r_cap,
                         int r_win, int* floor_true, int* floor) {
    int ft = lr;
    for (int r = 0; r < r_cap; ++r) {
        if (!rounds_decided[r] && r <= lr) {
            ft = r;
            break;
        }
    }
    *floor_true = ft;
    *floor = babble_clamp(ft, 0, r_cap - r_win);
}

__global__ void __launch_bounds__(DW_SETUP_THREADS)
dw_setup(const int32_t* __restrict__ wtable, const int32_t* __restrict__ la_w,
         const int32_t* __restrict__ fd_w, const int32_t* __restrict__ idx_w,
         const uint8_t* __restrict__ rounds_decided,
         const int32_t* __restrict__ last_round, int32_t* scal,
         uint32_t* ss_bits, uint32_t* vt0, int32_t* rcnt, int n, int r_cap, int r_win,
         int words, int super_majority) {
    extern __shared__ int4 dw_smem4[];
    int32_t* smem = reinterpret_cast<int32_t*>(dw_smem4);
    __shared__ const int32_t* a_rows[DW_ST];  // la_w rows y of round a (present, j > 0)
    __shared__ const int32_t* b_rows[DW_ST];  // fd_w rows w of round a - 1 (present)
    __shared__ int wv_n[DW_ST];               // voter y present in round a + 1
    __shared__ int idx_x[DW_ST];              // idx_w of column x in round a
    __shared__ int sh_floor;
    constexpr int TM = 4, TN = 4, TX = DW_ST / TN, TY = DW_ST / TM;
    constexpr int FLD = DW_ST + 1;  // the verdict tiles' row stride
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = DW_SETUP_THREADS / 32;
    const int j = blockIdx.x;
    const int y0 = blockIdx.y * DW_ST, w0 = blockIdx.z * DW_ST;
    const long long nn = (long long)n * n;

    if (threadIdx.x == 0) {
        int ft, fl;
        dw_floor(rounds_decided, *last_round, r_cap, r_win, &ft, &fl);
        sh_floor = fl;
        if (j == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
            scal[0] = fl;
            scal[1] = ft;
        }
        // the vote's per-round counts start at 0
        if (blockIdx.y == 0 && blockIdx.z == 0) {
            rcnt[3 * j] = rcnt[3 * j + 1] = rcnt[3 * j + 2] = 0;
        }
    }
    __syncthreads();
    const int a = sh_floor + j;
    int has_a = 0, has_b = 0;
    if (threadIdx.x < DW_ST) {
        const int t = threadIdx.x, y = y0 + t, w = w0 + t;
        const bool yj = j > 0 && y < n && wtable[(long long)a * n + y] >= 0;
        const bool wp = j > 0 && w < n && wtable[(long long)(a - 1) * n + w] >= 0;
        a_rows[t] = yj ? la_w + a * nn + (long long)y * n : nullptr;
        b_rows[t] = wp ? fd_w + (a - 1) * nn + (long long)w * n : nullptr;
        wv_n[t] = j + 1 < r_win && y < n && wtable[(long long)(a + 1) * n + y] >= 0;
        idx_x[t] = w < n ? idx_w[(long long)a * n + w] : 0;
        has_a = yj;
        has_b = wp;
    }
    // count only where the tile holds a present pair
    const int any_a = __syncthreads_or(has_a);
    const int any_b = __syncthreads_or(has_b);
    const bool go = any_a && any_b;
    int* flags = smem;  // (DW_ST, FLD) verdicts; the tile's ring before
    int cnt[TM][TN];
    if (go) {
        babble_count_ge_tile<DW_ST, DW_ST, TM, TN, DW_SETUP_STAGES>(
            smem, n, a_rows, b_rows, (n & 3) == 0, cnt);
        const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int q = 0; q < TN; ++q) {
                const int m = ty + i * TY, w = tx + q * TX;
                flags[m * FLD + w] = a_rows[m] != nullptr && b_rows[w] != nullptr
                                     && cnt[i][q] >= super_majority;
            }
        __syncthreads();
    }
    // ss row bits: word (w0 / 32 + h) of row y holds witnesses w0 + 32 h + lane
    for (int k = warp; k < DW_ST * (DW_ST / 32); k += n_warps) {
        const int m = k / (DW_ST / 32), h = k % (DW_ST / 32);
        const int wd = w0 / 32 + h;
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, go && flags[m * FLD + 32 * h + lane]);
        if (lane == 0 && y0 + m < n && wd < words) {
            ss_bits[((long long)j * n + y0 + m) * words + wd] = bits;
        }
    }
    __syncthreads();  // flags is rewritten next
    // d = 1 vote column bits: word (y0 / 32 + h) of column x holds voters
    // y0 + 32 h + lane of round a + 1
    const bool up = j + 1 < r_win;
    constexpr int PER = DW_ST * DW_ST / DW_SETUP_THREADS;  // every load in flight at once
    int v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int k = threadIdx.x + u * DW_SETUP_THREADS;
        const int m = k / DW_ST, xl = k % DW_ST;
        const int y = y0 + m, x = w0 + xl;
        v[u] = 0;
        if (up && y < n && x < n && wv_n[m]) {
            v[u] = la_w[(a + 1) * nn + (long long)y * n + x] >= idx_x[xl];
        }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int k = threadIdx.x + u * DW_SETUP_THREADS;
        flags[(k / DW_ST) * FLD + k % DW_ST] = v[u];
    }
    __syncthreads();
    for (int k = warp; k < DW_ST * (DW_ST / 32); k += n_warps) {
        const int xl = k / (DW_ST / 32), h = k % (DW_ST / 32);
        const int wd = y0 / 32 + h;
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, flags[(32 * h + lane) * FLD + xl]);
        if (lane == 0 && w0 + xl < n && wd < words) {
            vt0[((long long)j * n + w0 + xl) * words + wd] = bits;
        }
    }
}

template <int KC>
__global__ void __launch_bounds__(DW_VOTE_THREADS)
dw_vote(const int32_t* __restrict__ wtable, const uint8_t* __restrict__ coin_w,
        const int32_t* __restrict__ last_round, const int32_t* __restrict__ scal,
        const uint32_t* __restrict__ ss_bits, uint32_t* vt0, uint32_t* vt1, int32_t* rcnt,
        uint8_t* fame_decided, uint8_t* famous, uint8_t* rounds_decided,
        uint8_t* fame_lag, int n, int r_win, int words, int super_majority,
        int n_participants, int d_unroll) {
    extern __shared__ int4 dw_smem4[];
    int32_t* ring = reinterpret_cast<int32_t*>(dw_smem4);
    constexpr int LD = 4 * ((KC / 4) | 1);  // an odd count of 16-byte units
    constexpr int STAGE = (DW_YC + DW_XT) * LD;
    constexpr int XW = DW_XT / (DW_VOTE_THREADS / 32);  // columns per warp
    __shared__ int wv_i[DW_XT], dec[DW_XT], fam[DW_XT], any_dec[DW_XT], any_fam[DW_XT];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = blockIdx.x, x0 = blockIdx.y * DW_XT;
    const int fl = scal[0], ft = scal[1];
    const int lrr = *last_round - fl;
    const int a = fl + i;
    const bool aligned16 = (words & 3) == 0;

    if (threadIdx.x < DW_XT) {
        const int x = x0 + threadIdx.x;
        wv_i[threadIdx.x] = x < n && wtable[(long long)a * n + x] >= 0;
        dec[threadIdx.x] = fam[threadIdx.x] = 0;
    }
    __syncthreads();
    const uint32_t* cur = vt0;
    uint32_t* nxt = vt1;
    const int n_yc = (n + DW_YC - 1) / DW_YC, n_kc = (words + KC - 1) / KC;
    for (int d = 2; d < 2 + d_unroll; ++d) {
        const int j = i + d;
        // voters above last_round or the window: no decision from here on
        if (j > lrr || j > r_win - 1) break;
        // every column decided or absent: nothing left to change
        if (__syncthreads_and(threadIdx.x >= DW_XT || !wv_i[threadIdx.x] || dec[threadIdx.x])) {
            break;
        }
        const long long aj = (long long)(fl + j) * n;
        const bool is_coin = (d % n_participants) == 0;
        if (threadIdx.x < DW_XT) any_dec[threadIdx.x] = any_fam[threadIdx.x] = 0;
        const uint32_t* ss_j = ss_bits + (long long)j * n * words;
        const uint32_t* vt_i = cur + (long long)i * n * words;
        // chunk c: rows y of chunk c / n_kc, words of chunk c % n_kc
        auto load = [&](int c) {
            int32_t* st = ring + (c & 1) * STAGE;
            const int yc = (c / n_kc) * DW_YC, kc = (c % n_kc) * KC;
            babble_stage_async<DW_YC, KC, LD>(st, [&](int r) {
                return yc + r < n ? (const int32_t*)ss_j + (long long)(yc + r) * words : nullptr;
            }, kc, words, 0, aligned16);
            babble_stage_async<DW_XT, KC, LD>(st + DW_YC * LD, [&](int r) {
                return x0 + r < n ? (const int32_t*)vt_i + (long long)(x0 + r) * words : nullptr;
            }, kc, words, 0, aligned16);
        };
        const int chunks = n_yc * n_kc;
        load(0);
        babble_cp_async_commit();
        int yays[2][XW], total[2];
        for (int c = 0; c < chunks; ++c) {
            babble_cp_async_wait<0>();
            __syncthreads();
            if (c + 1 < chunks) load(c + 1);
            babble_cp_async_commit();
            if (c % n_kc == 0) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    total[h] = 0;
#pragma unroll
                    for (int m = 0; m < XW; ++m) yays[h][m] = 0;
                }
            }
            const int32_t* ss_t = ring + (c & 1) * STAGE;
            const int32_t* vt_t = ss_t + DW_YC * LD;
#pragma unroll
            for (int k = 0; k < KC; k += 4) {
                uint4 sv[2], vv[XW];
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    sv[h] = *reinterpret_cast<const uint4*>(ss_t + (lane + 32 * h) * LD + k);
#pragma unroll
                for (int m = 0; m < XW; ++m)
                    vv[m] = *reinterpret_cast<const uint4*>(vt_t + (warp + 8 * m) * LD + k);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    total[h] += __popc(sv[h].x) + __popc(sv[h].y) + __popc(sv[h].z)
                                + __popc(sv[h].w);
#pragma unroll
                    for (int m = 0; m < XW; ++m)
                        yays[h][m] += __popc(sv[h].x & vv[m].x) + __popc(sv[h].y & vv[m].y)
                                      + __popc(sv[h].z & vv[m].z) + __popc(sv[h].w & vv[m].w);
                }
            }
            if (c % n_kc != n_kc - 1) continue;
            // the y chunk's tallies are complete: its votes and decisions
            const int yc = (c / n_kc) * DW_YC;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int y = yc + 32 * h + lane;
                const bool y_ok = y < n;
                const bool wv_j = y_ok && wtable[aj + y] >= 0;
                const int coin = y_ok ? coin_w[aj + y] : 0;
#pragma unroll
                for (int m = 0; m < XW; ++m) {
                    const int xl = warp + 8 * m;
                    int nv = 0, dn = 0, dv = 0;
                    if (y_ok) {
                        const int nays = total[h] - yays[h][m];
                        const int v = yays[h][m] >= nays;
                        const bool strong = (v ? yays[h][m] : nays) >= super_majority;
                        if (is_coin) {
                            nv = strong ? v : coin;
                        } else {
                            nv = v;
                            dn = strong && wv_j && wv_i[xl] && !dec[xl];
                            dv = dn && v;
                        }
                    }
                    const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, nv);
                    const unsigned b_dn = __ballot_sync(BABBLE_FULL_MASK, dn);
                    const unsigned b_dv = __ballot_sync(BABBLE_FULL_MASK, dv);
                    const int wd = yc / 32 + h;
                    if (lane == 0) {
                        if (x0 + xl < n && wd < words) {
                            nxt[((long long)i * n + x0 + xl) * words + wd] = bits;
                        }
                        // column xl belongs to this warp alone
                        if (b_dn) any_dec[xl] = 1;
                        if (b_dv) any_fam[xl] = 1;
                    }
                }
            }
        }
        babble_cp_async_wait<0>();
        // the next offset's vote words: visible to this block's cp.async reads
        __threadfence();
        __syncthreads();
        if (threadIdx.x < DW_XT && any_dec[threadIdx.x]) {
            fam[threadIdx.x] = any_fam[threadIdx.x];
            dec[threadIdx.x] = 1;
        }
        const uint32_t* t = cur;
        cur = nxt;
        nxt = const_cast<uint32_t*>(t);
        __syncthreads();
    }

    int not_done = 0, valid = 0, lag = 0;
    if (threadIdx.x < DW_XT) {
        const int t = threadIdx.x;
        not_done = wv_i[t] && !dec[t];
        valid = wv_i[t];
        lag = wv_i[t] && !dec[t] && i + 2 + d_unroll <= lrr;
    }
    not_done = __syncthreads_or(not_done);
    valid = __syncthreads_or(valid);
    lag = __syncthreads_or(lag);
    if (threadIdx.x == 0 && (lag || (i == 0 && blockIdx.y == 0 && lrr >= r_win))) *fame_lag = 1;
    if (a < ft) return;  // frozen: a settled round keeps its stored fame
    if (threadIdx.x < DW_XT && x0 + threadIdx.x < n) {
        const long long k = (long long)a * n + x0 + threadIdx.x;
        fame_decided[k] = (uint8_t)dec[threadIdx.x];
        famous[k] = (uint8_t)fam[threadIdx.x];
    }
    if (threadIdx.x == 0) {
        // the round's verdict once every column block has added its own
        int32_t* c = rcnt + 3 * i;
        if (not_done) atomicAdd(c, 1);
        if (valid) atomicAdd(c + 1, 1);
        __threadfence();
        if (atomicAdd(c + 2, 1) == (int)gridDim.y - 1) {
            __threadfence();
            rounds_decided[a] = atomicAdd(c, 0) == 0 && atomicAdd(c + 1, 0) > 0;
        }
    }
}

// per round r: the famous-witness count, the min over famous witnesses of
// la_w[r, w, c], and whether r is decided and <= last_round. A block per
// (round, 128 columns c): the round's famous flags as bits in shared
// memory, then each thread walks the set bits only (babble_famous_min:
// every thread the same bits, so each load is coalesced over c), eight
// loads in flight.
#define DW_TABLES_THREADS 128
__global__ void __launch_bounds__(DW_TABLES_THREADS)
dw_tables(const int32_t* __restrict__ wtable, const int32_t* __restrict__ la_w,
          const uint8_t* __restrict__ fame_decided, const uint8_t* __restrict__ famous,
          const uint8_t* __restrict__ rounds_decided, const int32_t* __restrict__ last_round,
          int32_t* min_la, int32_t* famous_count, uint8_t* i_ok,
          const uint8_t* __restrict__ stale, const uint8_t* __restrict__ fame_lag,
          int32_t* pack_tab, int n, int r_cap) {
    extern __shared__ uint32_t fw[];  // (ceil(n / 32),) famous flags, a bit a witness
    __shared__ int total;
    const int r = blockIdx.x;
    const long long rn = (long long)r * n;
    const int lane = threadIdx.x & 31;
    const int words = (n + 31) / 32;
    if (threadIdx.x == 0) total = 0;
    __syncthreads();
    for (int w0 = threadIdx.x - lane; w0 < n; w0 += blockDim.x) {
        const int w = w0 + lane;
        const bool f = w < n && fame_decided[rn + w] && famous[rn + w] && wtable[rn + w] >= 0;
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, f);
        if (lane == 0) {
            fw[w0 >> 5] = bits;
            if (bits) atomicAdd(&total, __popc(bits));
        }
    }
    __syncthreads();
    const int c = blockIdx.y * blockDim.x + threadIdx.x;
    if (c < n) {
        const int m = babble_famous_min(fw, 0, words, c, BABBLE_FULL_MASK, [=](int w) {
            return la_w + (rn + w) * n;
        });
        min_la[rn + c] = m;
        if (pack_tab != nullptr) {
            const long long r_n = (long long)r_cap * n;
            pack_tab[rn + c] = wtable[rn + c];
            pack_tab[r_n + rn + c] = fame_decided[rn + c] != 0;
            pack_tab[2 * r_n + rn + c] = famous[rn + c] != 0;
        }
    }
    if (threadIdx.x == 0 && blockIdx.y == 0) {
        famous_count[r] = total;
        i_ok[r] = rounds_decided[r] && r <= *last_round;
        if (pack_tab != nullptr && r == 0) {
            int32_t* flags = pack_tab + 3LL * r_cap * n;
            flags[0] = *stale != 0;
            flags[1] = *fame_lag != 0;
            flags[2] = *last_round;
        }
    }
}

// dw_events with `pack` (rows from `pack_lo`, the host's window start: a
// launch whose count places the window elsewhere traps; `flags` the
// vector's three scalar words, which dw_tables wrote)
__global__ void dw_events(const int32_t* __restrict__ index,
                          const int32_t* __restrict__ creator,
                          const int32_t* __restrict__ rounds,
                          const int32_t* __restrict__ count,
                          const int32_t* __restrict__ min_la,
                          const int32_t* __restrict__ famous_count,
                          const uint8_t* __restrict__ i_ok,
                          int32_t* received, uint8_t* stale,
                          const int32_t* __restrict__ lamport,
                          const uint8_t* __restrict__ witness,
                          int32_t* pack, int32_t* flags, int pack_lo,
                          int e_cap, int n, int r_cap, int e_win) {
    extern __shared__ int32_t horizon[];  // (r_cap,) first round >= k not i_ok
    for (int r = threadIdx.x; r < r_cap; r += blockDim.x) horizon[r] = i_ok[r];
    __syncthreads();
    if (threadIdx.x == 0) {
        int h = r_cap;
        for (int r = r_cap - 1; r >= 0; --r) {
            if (!horizon[r]) h = r;
            horizon[r] = h;
        }
    }
    __syncthreads();
    const long long lo_l = (long long)*count - e_win;
    const int lo = (int)(lo_l < 0 ? 0 : (lo_l > e_cap - e_win ? e_cap - e_win : lo_l));
    if (pack != nullptr && pack_lo != lo) __trap();
    const long long stride = (long long)gridDim.x * blockDim.x;
    int miss = 0;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < e_cap;
         k += stride) {
        if (k < lo) {
            miss |= received[k] < 0 && index[k] != BABBLE_MAX_INT32;
            continue;
        }
        if (k >= (long long)lo + e_win) continue;
        const int idx = index[k];
        int res = received[k];
        if (res < 0 && idx != BABBLE_MAX_INT32) {
            const int rd = rounds[k];
            const int c = creator[k];
            const bool c_ok = c >= 0 && c < n;
            const int stop = min(horizon[babble_clamp(rd + 1, 0, r_cap - 1)], r_cap);
            res = -1;
            for (int i = max(rd + 1, 0); i < stop; ++i) {
                const int seen = c_ok ? min(min_la[(long long)i * n + c], DW_FD_CLAMP) : 0;
                if (famous_count[i] > 0 && i_ok[i] && idx <= seen) {
                    res = i;
                    break;
                }
            }
            received[k] = res;
        }
        if (pack != nullptr) {
            const long long q = k - lo;
            pack[q] = rounds[k];
            pack[e_win + q] = lamport[k];
            pack[2LL * e_win + q] = witness[k] != 0;
            pack[3LL * e_win + q] = res;
        }
    }
    if (__syncthreads_or(miss) && threadIdx.x == 0) {
        *stale = 1;
        if (pack != nullptr) flags[0] = 1;
    }
}

extern "C" int babble_decide_window(
    const int32_t* wtable, const int32_t* la_w, const int32_t* fd_w,
    const int32_t* idx_w, const uint8_t* coin_w, uint8_t* fame_decided,
    uint8_t* famous, uint8_t* rounds_decided, const int32_t* last_round,
    const int32_t* count, const int32_t* index, const int32_t* creator,
    const int32_t* rounds, int32_t* received, uint8_t* stale, uint8_t* fame_lag,
    int32_t* scal, uint32_t* ss_bits, uint32_t* vt0, uint32_t* vt1, int32_t* rcnt,
    int32_t* min_la, int32_t* famous_count, uint8_t* i_ok, const int32_t* lamport,
    const uint8_t* witness, int32_t* pack,
    int e_cap, int n, int r_cap, int r_win, int e_win, int super_majority,
    int n_participants, int d_unroll, int pack_lo, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int words = (n + 31) / 32;
    const int tiles = (n + DW_ST - 1) / DW_ST;

    const size_t smem_setup =
        babble_count_tile_words<DW_ST, DW_ST, DW_SETUP_STAGES>() * sizeof(int32_t);
    BABBLE_CHECK(babble_allow_smem(dw_setup, smem_setup));
    dw_setup<<<dim3(r_win, tiles, tiles), DW_SETUP_THREADS, smem_setup, s>>>(
        wtable, la_w, fd_w, idx_w, rounds_decided, last_round, scal, ss_bits, vt0, rcnt,
        n, r_cap, r_win, words, super_majority);
    BABBLE_CHECK_LAUNCH();

    // the ring is sized for the widest stage at every width; narrower
    // vote words take a narrower stage (no popcounts of padding)
    const size_t smem_vote = (size_t)2 * (DW_YC + DW_XT) * DW_VOTE_LD * sizeof(int32_t);
    const dim3 grid_vote(r_win, (n + DW_XT - 1) / DW_XT);
#define DW_VOTE_LAUNCH(KC)                                                            \
    do {                                                                              \
        BABBLE_CHECK(babble_allow_smem(dw_vote<KC>, smem_vote));                      \
        dw_vote<KC><<<grid_vote, DW_VOTE_THREADS, smem_vote, s>>>(                    \
            wtable, coin_w, last_round, scal, ss_bits, vt0, vt1, rcnt, fame_decided,  \
            famous, rounds_decided, fame_lag, n, r_win, words, super_majority,        \
            n_participants, d_unroll);                                                \
    } while (0)
    if (words <= 4) DW_VOTE_LAUNCH(4);
    else if (words <= 8) DW_VOTE_LAUNCH(8);
    else if (words <= 16) DW_VOTE_LAUNCH(16);
    else DW_VOTE_LAUNCH(DW_KC_MAX);
#undef DW_VOTE_LAUNCH
    BABBLE_CHECK_LAUNCH();

    const dim3 grid_tables(r_cap, (n + DW_TABLES_THREADS - 1) / DW_TABLES_THREADS);
    int32_t* pack_tab = pack != nullptr ? pack + 4LL * e_win : nullptr;
    dw_tables<<<grid_tables, DW_TABLES_THREADS, (size_t)words * sizeof(uint32_t), s>>>(
        wtable, la_w, fame_decided, famous, rounds_decided, last_round, min_la, famous_count,
        i_ok, stale, fame_lag, pack_tab, n, r_cap);
    BABBLE_CHECK_LAUNCH();

    size_t smem_events = (size_t)r_cap * sizeof(int32_t);
    BABBLE_CHECK(babble_allow_smem(dw_events, smem_events));
    dw_events<<<babble_stride_blocks(e_cap, 256), 256, smem_events, s>>>(
        index, creator, rounds, count, min_la, famous_count, i_ok, received,
        stale, lamport, witness, pack,
        pack_tab != nullptr ? pack_tab + 3LL * r_cap * n : nullptr, pack_lo, e_cap, n, r_cap,
        e_win);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
