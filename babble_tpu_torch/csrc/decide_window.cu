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
// Bound: bytes and launches. The window reads la_w / fd_w (2 x r_win x N x N
// int32, 2 MB at 64 rounds of 64 x 64) and the e_win rows' index /
// creator / rounds / received; the tallies are 8 x r_win x N x N popcounts
// of N / 32 words. The card's time goes to chains of dependent loads, so
// each launch fetches what it needs in one round trip: setup (one block
// per window round: the la_w / fd_w rows of its round and both
// neighbours staged in shared memory padded to N + 1 words, then ss rows
// and the d = 1 vote columns as bit words), vote (one block per window
// round, all eight offsets' rows fetched at once, the votes in shared
// memory), tables (one block per round, eight loads in flight per thread)
// and events (a grid over all E_cap rows: received in the window, the
// stale detector below it; the horizon scanned in shared memory).

#include "common.cuh"

// setup and vote give each block all 32 warps: their per-warp work is a
// chain of shared-memory round trips, so more warps hide more latency
#define DW_THREADS 1024
#define DW_WARPS (DW_THREADS / 32)
#define DW_FD_CLAMP (1 << 24)

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

__global__ void __launch_bounds__(DW_THREADS)
dw_setup(const int32_t* __restrict__ wtable, const int32_t* __restrict__ la_w,
         const int32_t* __restrict__ fd_w, const int32_t* __restrict__ idx_w,
         const uint8_t* __restrict__ rounds_decided,
         const int32_t* __restrict__ last_round, int32_t* scal,
         uint32_t* ss_bits, uint32_t* vt0, int n, int r_cap, int r_win,
         int words, int super_majority) {
    extern __shared__ int32_t smem[];
    const int ld = n + 1;            // padded row stride: conflict-free columns
    int32_t* la_s = smem;            // (n, ld) la_w rows of round a
    int32_t* fd_s = la_s + n * ld;   // (n, ld) fd_w rows of round a - 1
    int32_t* la_n = fd_s + n * ld;   // (n, ld) la_w rows of round a + 1
    int32_t* wv_j = la_n + n * ld;   // (n,) witness present in round a
    int32_t* wv_p = wv_j + n;        // ... in round a - 1 (inside the window)
    int32_t* wv_n = wv_p + n;        // ... in round a + 1 (inside the window)
    int32_t* idx_a = wv_n + n;       // (n,) idx_w of round a
    __shared__ int sh_floor;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int j = blockIdx.x;

    if (threadIdx.x == 0) {
        int ft, fl;
        dw_floor(rounds_decided, *last_round, r_cap, r_win, &ft, &fl);
        sh_floor = fl;
        if (j == 0) {
            scal[0] = fl;
            scal[1] = ft;
        }
    }
    __syncthreads();
    const int a = sh_floor + j;
    for (int k = threadIdx.x; k < n * n; k += blockDim.x) {
        const int y = k / n, q = k % n;
        la_s[y * ld + q] = la_w[(long long)a * n * n + k];
        if (j > 0) fd_s[y * ld + q] = fd_w[(long long)(a - 1) * n * n + k];
        if (j + 1 < r_win) la_n[y * ld + q] = la_w[(long long)(a + 1) * n * n + k];
    }
    for (int y = threadIdx.x; y < n; y += blockDim.x) {
        wv_j[y] = wtable[(long long)a * n + y] >= 0;
        wv_p[y] = j > 0 && wtable[(long long)(a - 1) * n + y] >= 0;
        wv_n[y] = j + 1 < r_win && wtable[(long long)(a + 1) * n + y] >= 0;
        idx_a[y] = idx_w[(long long)a * n + y];
    }
    __syncthreads();

    // ss row bits: word wd of row y holds witnesses w = 32 wd + lane
    for (int task = warp; task < n * words; task += DW_WARPS) {
        const int y = task / words, wd = task % words;
        const int wi = wd * 32 + lane;
        int s = 0;
        if (wi < n && wv_j[y] && wv_p[wi]) {
            int cnt = 0;
            for (int q = 0; q < n; ++q) cnt += la_s[y * ld + q] >= fd_s[wi * ld + q];
            s = cnt >= super_majority;
        }
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, s);
        if (lane == 0) ss_bits[((long long)j * n + y) * words + wd] = bits;
    }
    // d = 1 vote column bits: word wd of column x holds voters y = 32 wd + lane
    for (int task = warp; task < n * words; task += DW_WARPS) {
        const int x = task / words, wd = task % words;
        const int y = wd * 32 + lane;
        int v = 0;
        if (y < n && wv_n[y]) v = la_n[y * ld + x] >= idx_a[x];
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, v);
        if (lane == 0) vt0[((long long)j * n + x) * words + wd] = bits;
    }
}

__global__ void __launch_bounds__(DW_THREADS)
dw_vote(const int32_t* __restrict__ wtable, const uint8_t* __restrict__ coin_w,
        const int32_t* __restrict__ last_round, const int32_t* __restrict__ scal,
        const uint32_t* __restrict__ ss_bits, const uint32_t* __restrict__ vt0,
        uint8_t* fame_decided, uint8_t* famous, uint8_t* rounds_decided,
        uint8_t* fame_lag, int n, int r_win, int words, int super_majority,
        int n_participants, int d_unroll) {
    extern __shared__ int32_t smem[];
    const int nw = n * words;
    uint32_t* vt = (uint32_t*)smem;  // (n, words) vote columns of round i
    uint32_t* vt_next = vt + nw;
    uint32_t* ss_all = vt_next + nw; // (d_unroll, n, words) ss rows of each voting round
    int32_t* wv_i = (int32_t*)(ss_all + d_unroll * nw);  // (n,) witness x present in round i
    int32_t* wv_all = wv_i + n;      // (d_unroll, n) voter y present in each voting round
    int32_t* coin_all = wv_all + d_unroll * n;  // (d_unroll, n) voter y's coin bit
    int32_t* dec = coin_all + d_unroll * n;     // (n,) decided[x]
    int32_t* fam = dec + n;          // (n,) famous[x]
    int32_t* any_dec = fam + n;      // (n,) this offset's decisions
    int32_t* any_fam = any_dec + n;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int i = blockIdx.x;
    const int fl = scal[0], ft = scal[1];
    const int lrr = *last_round - fl;
    const int a = fl + i;

    for (int k = threadIdx.x; k < nw; k += blockDim.x) vt[k] = vt0[(long long)i * nw + k];
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        wv_i[x] = wtable[(long long)a * n + x] >= 0;
        dec[x] = fam[x] = any_dec[x] = any_fam[x] = 0;
    }
    // every offset's voting rows at once: one round trip, not one per offset
    for (int k = threadIdx.x; k < d_unroll * nw; k += blockDim.x) {
        const int j = i + 2 + k / nw;
        const bool j_ok = j <= lrr && j <= r_win - 1;
        ss_all[k] = j_ok ? ss_bits[(long long)babble_clamp(j, 0, r_win - 1) * nw + k % nw] : 0u;
    }
    for (int k = threadIdx.x; k < d_unroll * n; k += blockDim.x) {
        const long long aj = (long long)(fl + babble_clamp(i + 2 + k / n, 0, r_win - 1)) * n;
        wv_all[k] = wtable[aj + k % n] >= 0;
        coin_all[k] = coin_w[aj + k % n];
    }
    __syncthreads();
    for (int d = 2; d < 2 + d_unroll; ++d) {
        const int j = i + d;
        const bool j_ok = j <= lrr && j <= r_win - 1;
        const uint32_t* ss_r = ss_all + (d - 2) * nw;  // zero where !j_ok
        const int32_t* wv_j = wv_all + (d - 2) * n;
        const int32_t* coin_j = coin_all + (d - 2) * n;
        const bool is_coin = (d % n_participants) == 0;
        for (int task = warp; task < nw; task += DW_WARPS) {
            const int x = task / words, wd = task % words;
            const int y = wd * 32 + lane;
            int nv = 0, dn = 0, dv = 0;
            if (y < n) {
                int yays = 0, total = 0;
                for (int k = 0; k < words; ++k) {
                    const uint32_t s = ss_r[y * words + k];
                    yays += __popc(s & vt[x * words + k]);
                    total += __popc(s);
                }
                const int nays = total - yays;
                const int v = yays >= nays;
                const bool strong = (v ? yays : nays) >= super_majority;
                if (is_coin) {
                    nv = strong ? v : coin_j[y];
                } else {
                    nv = v;
                    dn = strong && j_ok && wv_j[y] && wv_i[x] && !dec[x];
                    dv = dn && v;
                }
            }
            const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, nv);
            const unsigned b_dn = __ballot_sync(BABBLE_FULL_MASK, dn);
            const unsigned b_dv = __ballot_sync(BABBLE_FULL_MASK, dv);
            if (lane == 0) {
                vt_next[task] = bits;
                // benign races: every writer stores 1
                if (b_dn) any_dec[x] = 1;
                if (b_dv) any_fam[x] = 1;
            }
        }
        __syncthreads();
        for (int x = threadIdx.x; x < n; x += blockDim.x) {
            if (any_dec[x]) {
                fam[x] = any_fam[x];
                dec[x] = 1;
                any_dec[x] = any_fam[x] = 0;
            }
        }
        for (int k = threadIdx.x; k < nw; k += blockDim.x) vt[k] = vt_next[k];
        __syncthreads();
    }

    int all_done = 1, any_valid = 0, lag = 0;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        all_done &= dec[x] || !wv_i[x];
        any_valid |= wv_i[x];
        lag |= wv_i[x] && !dec[x] && i + 2 + d_unroll <= lrr;
    }
    all_done = __syncthreads_and(all_done);
    any_valid = __syncthreads_or(any_valid);
    lag = __syncthreads_or(lag);
    if (threadIdx.x == 0 && (lag || (i == 0 && lrr >= r_win))) *fame_lag = 1;
    if (a < ft) return;  // frozen: a settled round keeps its stored fame
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        fame_decided[(long long)a * n + x] = (uint8_t)dec[x];
        famous[(long long)a * n + x] = (uint8_t)fam[x];
    }
    if (threadIdx.x == 0) rounds_decided[a] = all_done && any_valid;
}

// per round r: the famous-witness count, the min over famous witnesses of
// la_w[r, w, c], and whether r is decided and <= last_round
__global__ void dw_tables(const int32_t* __restrict__ wtable,
                          const int32_t* __restrict__ la_w,
                          const uint8_t* __restrict__ fame_decided,
                          const uint8_t* __restrict__ famous,
                          const uint8_t* __restrict__ rounds_decided,
                          const int32_t* __restrict__ last_round,
                          int32_t* min_la, int32_t* famous_count, uint8_t* i_ok,
                          int n) {
    extern __shared__ int32_t fw[];  // (n,) famous flag of each witness
    __shared__ int total;
    const int r = blockIdx.x;
    if (threadIdx.x == 0) total = 0;
    __syncthreads();
    int local = 0;
    for (int w = threadIdx.x; w < n; w += blockDim.x) {
        const long long k = (long long)r * n + w;
        fw[w] = fame_decided[k] && famous[k] && wtable[k] >= 0;
        local += fw[w];
    }
    if (local) atomicAdd(&total, local);
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        int m = BABBLE_MAX_INT32;
        for (int w0 = 0; w0 < n; w0 += 8) {
            int v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int w = w0 + u;
                v[u] = (w < n && fw[w]) ? la_w[((long long)r * n + w) * n + c]
                                        : BABBLE_MAX_INT32;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) m = min(m, v[u]);
        }
        min_la[(long long)r * n + c] = m;
    }
    if (threadIdx.x == 0) {
        famous_count[r] = total;
        i_ok[r] = rounds_decided[r] && r <= *last_round;
    }
}

__global__ void dw_events(const int32_t* __restrict__ index,
                          const int32_t* __restrict__ creator,
                          const int32_t* __restrict__ rounds,
                          const int32_t* __restrict__ count,
                          const int32_t* __restrict__ min_la,
                          const int32_t* __restrict__ famous_count,
                          const uint8_t* __restrict__ i_ok,
                          int32_t* received, uint8_t* stale,
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
        if (received[k] >= 0 || idx == BABBLE_MAX_INT32) continue;
        const int rd = rounds[k];
        const int c = creator[k];
        const bool c_ok = c >= 0 && c < n;
        const int stop = min(horizon[babble_clamp(rd + 1, 0, r_cap - 1)], r_cap);
        int res = -1;
        for (int i = max(rd + 1, 0); i < stop; ++i) {
            const int seen = c_ok ? min(min_la[(long long)i * n + c], DW_FD_CLAMP) : 0;
            if (famous_count[i] > 0 && i_ok[i] && idx <= seen) {
                res = i;
                break;
            }
        }
        received[k] = res;
    }
    if (__syncthreads_or(miss) && threadIdx.x == 0) *stale = 1;
}

extern "C" int babble_decide_window(
    const int32_t* wtable, const int32_t* la_w, const int32_t* fd_w,
    const int32_t* idx_w, const uint8_t* coin_w, uint8_t* fame_decided,
    uint8_t* famous, uint8_t* rounds_decided, const int32_t* last_round,
    const int32_t* count, const int32_t* index, const int32_t* creator,
    const int32_t* rounds, int32_t* received, uint8_t* stale, uint8_t* fame_lag,
    int32_t* scal, uint32_t* ss_bits, uint32_t* vt0, int32_t* min_la,
    int32_t* famous_count, uint8_t* i_ok,
    int e_cap, int n, int r_cap, int r_win, int e_win, int super_majority,
    int n_participants, int d_unroll, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int words = (n + 31) / 32;

    size_t smem_setup = ((size_t)3 * n * (n + 1) + (size_t)4 * n) * sizeof(int32_t);
    if (smem_setup > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            dw_setup, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_setup));
    }
    dw_setup<<<r_win, DW_THREADS, smem_setup, s>>>(
        wtable, la_w, fd_w, idx_w, rounds_decided, last_round, scal, ss_bits,
        vt0, n, r_cap, r_win, words, super_majority);
    BABBLE_CHECK_LAUNCH();

    size_t smem_vote = ((size_t)(2 + d_unroll) * n * words + (size_t)(5 + 2 * d_unroll) * n)
                       * sizeof(int32_t);
    if (smem_vote > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            dw_vote, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_vote));
    }
    dw_vote<<<r_win, DW_THREADS, smem_vote, s>>>(
        wtable, coin_w, last_round, scal, ss_bits, vt0, fame_decided, famous,
        rounds_decided, fame_lag, n, r_win, words, super_majority,
        n_participants, d_unroll);
    BABBLE_CHECK_LAUNCH();

    size_t smem_tables = (size_t)n * sizeof(int32_t);
    if (smem_tables > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            dw_tables, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tables));
    }
    dw_tables<<<r_cap, 128, smem_tables, s>>>(
        wtable, la_w, fame_decided, famous, rounds_decided, last_round, min_la,
        famous_count, i_ok, n);
    BABBLE_CHECK_LAUNCH();

    size_t smem_events = (size_t)r_cap * sizeof(int32_t);
    if (smem_events > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            dw_events, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_events));
    }
    dw_events<<<babble_stride_blocks(e_cap, 256), 256, smem_events, s>>>(
        index, creator, rounds, count, min_la, famous_count, i_ok, received,
        stale, e_cap, n, r_cap, e_win);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
