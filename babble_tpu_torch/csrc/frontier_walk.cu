// frontier_rounds: the round-frontier DivideRounds walk.
//
// Replaces babble_tpu/tpu/frontier.py:299 _frontier_rounds (make_walk_step
// with _m0_einsum_sort / _m0_binsearch, frontier_x0 and frontier_post).
//
// One walk step X(r) -> X(r+1):
//   fd_w[w, p] = fd[rows_by[w, X(r)[w]], p]              (MAX if X(r)[w] = L)
//   t[w, c]    = super_majority-th smallest over p of INV[c, p, fd_w[w, p]]
//   m0[c]      = super_majority-th smallest over w of t[w, c]
//   X(r+1)[c]  = clamp(min(m0[c], min_c' INV[c, c', m0[c']]), X(r)[c], L)
// then the witness table and each event's round and witness flag from the
// frontier history X(0..r_cap-1).
//
// The reference contracts the value axis with one-hot f32 einsums and sorts
// an (N, N, N) tensor; here INV is read by direct int32 loads and both
// selections are count-based binary searches over [0, L] done by one warp
// each (a warp-wide count per probe), so nothing N^3-sized is stored and the
// integers equal the sort form at every N.
//
// Bound: bytes. INV and fd are each read at most once per step from L2
// (16.8 MB each at 64 validators, L = 1024, 65,536 rows; both fit in the
// 50 MB L2), the per-event pass reads the (E,) arrays once. The walk is
// sequential over r_cap steps, two launches per step (walk_m0, walk_close)
// plus three more: 2 * (r_cap - 1) + 3 launches per call.
//
// frontier_window (babble_frontier_window) is the walk half of the
// frontier-live engine's decide, replacing babble_tpu/tpu/frontier_live.py
// :184 _decide up to its fame vote. Over the maintained tables (INV,
// rows_by, the stored frontier history x_hist, the dirty chains):
//   floor = min over dirty chains of |{r : x_hist[r, c] < L}| (R_cap if
//           none), clipped to [0, R_cap - r_win]; start = max(floor - 1, 0);
//   seed  = X(0) if floor = 0, else x_hist[start];
//   r_win steps from the seed, fd_w[w, p] = INV[p, w, X[w]] (MAX where
//           that is L or X[w] = L: the first descendant on chain p of
//           frontier row w, fd[e, p] == INV[p, creator(e), index(e)]),
//           written to rows start .. start + r_win - 1 of a copy of
//           x_hist; r_over latches when X(start + r_win) still holds a row;
//   the post pass over the whole history, sp_index = index - 1;
//   the witness tables of the voting: la_w[r, c] = la[row], idx_w (MAX
//           where absent), coin_w, fd_w[r, c, p] = INV[p, c, idx_w[r, c]]
//           (MAX where absent or L), and the compact table wtable_c[r, c]
//           = r N + c (-1 where absent) through which decide_fame and
//           round_received read them.
// The reference forces the binary-search m0 here; the count-based
// selection of walk_m0 gives the same integers (both find the first
// chain index seeing a supermajority of the frontier rows, by lastAncestors
// or by the INV built from them). Bound: operations, about N^2 INV loads
// and compares per step (N^3 with the selection's probes); launches:
// 2 r_win + 5.

// The device mesh (babble_tpu/tpu/sharded.py:549 local_walk, replaced
// here) walks the same frontier with INV and the chain table sharded over
// chains: each position owns B chains, fd and la are replicated, and the
// frontier rows and m0 cross the mesh by two tiled all-gathers per step.
// Three launches per step per position:
//   shard_rows   fd_w_local[b, p] = fd[rows_by[b, X[b]], p] (MAX where X[b]
//                = L) and w_ok[b] = X[b] < L, a block per local chain;
//   shard_m0     m0_local[c] from the gathered (N_w, N_p) frontier rows and
//                the local INV slice: walk_m0's count-based selection fed
//                the rows directly (one selection gives the integers of the
//                reference's sort form and of its binary search, as above);
//   shard_close  walk_close on the local chains from the gathered m0,
//                its coordinates cut to the real width N_p, writing X(r+1).
// babble_frontier_post launches post_table and post_events alone: the
// witness table and the events' rounds from the gathered history
// (sharded.py:691). Bound: bytes; each step reads the frontier rows' fd
// (N_w x N_p int32) and one INV value per (chain, coordinate) probed.
//
// babble_shard_walk runs the same walk for a mesh whose positions all lie
// on one device as ONE cooperative launch over every chain of every
// position (sw_grid): the three kernels above, 3 (r_cap - 1) launches per
// position, become phases of a step separated by grid barriers, and the
// all-gathers become reads of a scratch in L2. A step X(r) -> X(r+1):
//   A  t[c, j] for every chain c and every live frontier row (X(r)[w] <
//      L), a warp each: the super_majority-th smallest over p of
//      INV_c[p, fd[e, p]], e the row's event (the live list holds the
//      events, listed at the end of the step before; their fd rows are
//      read coalesced, as a staged table would be); rows with X(r)[w] = L
//      have t = L, and a selection's probes stay below L, so they never
//      count and are left out;
//   -- barrier; m0[c], a warp per chain: the super_majority-th smallest of
//      t[c, :] (L where fewer rows are live);
//   -- barrier; B  the closure of each chain over m0[0:N_p], X(r+1) into
//      its position's history, a count of the chains that moved, and the
//      chain's next frontier event on the live list;
//   -- barrier. When no chain moved, X(r+1) = X(r): F depends on X alone,
//      so every later row repeats it; the blocks fill rows r+2 .. r_cap-1
//      and return. The history equals the full-length walk row for row.
// Each selection keeps its values in registers (32 R of them a warp, R =
// 8 up to 256 chains and coordinates, 32 above; any past those are
// produced again at each probe), and searches [min, max] of the values,
// not [0, L]: the same integers as warp_select. Shared memory: none, at
// every width. Bound: bytes, the frontier rows and the INV values the
// working steps probe. In practice phase A is bound by L1's rate in cache
// lines: a warp's gather of INV_c[p, f] over 32 coordinates touches 32
// lines (n_w x live rows x N_p of them a step), and the frontier rows'
// values on one coordinate lie too far apart to share lines.

#include "common.cuh"

#define WALK_WARPS 8

// k-th smallest (1-based) of buf[0:n], all values in [0, hi]; every lane of
// the calling warp returns it. Smallest v with |{buf <= v}| >= k.
__device__ int warp_select(const int32_t* buf, int n, int k, int hi) {
    int lane = threadIdx.x & 31;
    int lo = 0;
    while (lo < hi) {
        int mid = lo + ((hi - lo) >> 1);
        int cnt = 0;
        for (int p = lane; p < n; p += 32) cnt += buf[p] <= mid;
        cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
        if (cnt >= k) hi = mid; else lo = mid + 1;
    }
    return lo;
}

// X(0): every non-empty chain starts at index 0 (base grids)
__global__ void walk_x0(const int32_t* __restrict__ rows_by, int32_t* x0, int n, int l) {
    int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c < n) x0[c] = rows_by[(long long)c * l] >= 0 ? 0 : l;
}

// one block per chain c: m0[c] from the frontier X(r). The frontier rows'
// first descendants come from fd (FROM_INV false), or from INV itself:
// fd_w[w, p] = INV[p, w, X(r)[w]], L meaning none (FROM_INV true)
template <bool FROM_INV>
__global__ void walk_m0(const int32_t* __restrict__ inv,
                        const int32_t* __restrict__ rows_by,
                        const int32_t* __restrict__ fd,
                        const int32_t* __restrict__ x_cur, int32_t* m0,
                        int n, int l, int e_fd, int super_majority) {
    extern __shared__ int32_t smem[];
    int32_t* xs = smem;              // (n,) the frontier
    int32_t* t = xs + n;             // (n,) t[w] for this chain
    int32_t* ubuf = t + n;           // (WALK_WARPS, n) one row per warp
    const int c = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int32_t* u = ubuf + (long long)warp * n;

    for (int w = threadIdx.x; w < n; w += blockDim.x) xs[w] = x_cur[w];
    __syncthreads();

    const int32_t* inv_c = inv + (long long)c * n * l;
    for (int w = warp; w < n; w += WALK_WARPS) {
        int x = xs[w];
        if (x >= l) {  // no frontier row on chain w: every u is L
            if (lane == 0) t[w] = l;
            continue;
        }
        const int32_t* fd_row = nullptr;
        if (!FROM_INV) {
            const int row = babble_clamp(rows_by[(long long)w * l + x], 0, e_fd - 1);
            fd_row = fd + (long long)row * n;
        }
        for (int p = lane; p < n; p += 32) {
            int f;
            if (FROM_INV) {
                const int v = inv[((long long)p * n + w) * l + x];
                f = v < l ? v : BABBLE_MAX_INT32;
            } else {
                f = fd_row[p];
            }
            u[p] = f < BABBLE_MAX_INT32
                       ? inv_c[(long long)p * l + babble_clamp(f, 0, l - 1)]
                       : l;
        }
        __syncwarp();
        int tw = warp_select(u, n, super_majority, l);
        if (lane == 0) t[w] = tw;
        __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {
        int m = warp_select(t, n, super_majority, l);
        if (lane == 0) m0[c] = m;
    }
}

// one warp per chain c: the cross-chain closure and the clamp
__global__ void walk_close(const int32_t* __restrict__ inv,
                           const int32_t* __restrict__ m0,
                           const int32_t* __restrict__ x_cur, int32_t* x_next,
                           int n, int l) {
    const int c = blockIdx.x;
    const int lane = threadIdx.x;
    int r = l;
    const int32_t* inv_c = inv + (long long)c * n * l;
    for (int c2 = lane; c2 < n; c2 += 32) {
        int mc = m0[c2];
        if (mc < l) r = min(r, inv_c[(long long)c2 * l + mc]);
    }
    r = __reduce_min_sync(BABBLE_FULL_MASK, r);
    if (lane == 0) {
        int xn = min(m0[c], r);
        x_next[c] = min(max(xn, x_cur[c]), l);
    }
}

// witness table from the history: chain c has an exact-round-r witness
// iff the frontier moved past its row at r+1
__global__ void post_table(const int32_t* __restrict__ x_hist,
                           const int32_t* __restrict__ rows_by,
                           int32_t* wtable, int32_t* last_round,
                           int r_cap, int n, int l) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k == 0) *last_round = BABBLE_MIN_INT32;
    if (k >= r_cap * n) return;
    int r = k / n, c = k % n;
    int xh = x_hist[k];
    int xn = r + 1 < r_cap ? x_hist[k + n] : l;
    bool valid = xh < l && xn > xh;
    wtable[k] = valid ? max(rows_by[(long long)c * l + babble_clamp(xh, 0, l - 1)], 0) : -1;
}

// per-event round = (thresholds passed) - 1; witness = round exceeds the
// self-parent's; last_round = max round (warp max, then one atomic)
__global__ void post_events(const int32_t* __restrict__ x_hist,
                            const int32_t* __restrict__ creator,
                            const int32_t* __restrict__ index,
                            const int32_t* __restrict__ sp_index,
                            int32_t* rounds, uint8_t* witness, int32_t* last_round,
                            int e, int r_cap, int n) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    int rd = BABBLE_MIN_INT32;
    if (k < e) {
        int c = babble_clamp(creator[k], 0, n - 1);
        // no sp_index table: each event's self-parent is its index - 1
        int idx = index[k], spi = sp_index != nullptr ? sp_index[k] : idx - 1;
        int cnt = 0, spc = 0;
        for (int r = 0; r < r_cap; ++r) {
            int xv = x_hist[r * n + c];
            cnt += idx >= xv;
            spc += spi >= xv;
        }
        rd = cnt - 1;
        rounds[k] = rd;
        witness[k] = rd > spc - 1;
    }
    int m = __reduce_max_sync(BABBLE_FULL_MASK, rd);
    if ((threadIdx.x & 31) == 0 && m != BABBLE_MIN_INT32) atomicMax(last_round, m);
}

extern "C" int babble_frontier_rounds(
    const int32_t* inv, const int32_t* rows_by, const int32_t* creator,
    const int32_t* index, const int32_t* sp_index, const int32_t* fd,
    int32_t* x_hist, int32_t* m0, int32_t* rounds, uint8_t* witness,
    int32_t* wtable, int32_t* last_round,
    int n, int l, int e, int e_fd, int super_majority, int r_cap,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    size_t smem = (size_t)(2 + WALK_WARPS) * n * sizeof(int32_t);
    BABBLE_CHECK(babble_allow_smem(walk_m0<false>, smem));
    walk_x0<<<babble_blocks(n, 128), 128, 0, s>>>(rows_by, x_hist, n, l);
    BABBLE_CHECK_LAUNCH();
    for (int r = 0; r + 1 < r_cap; ++r) {
        const int32_t* x_cur = x_hist + (long long)r * n;
        int32_t* x_next = x_hist + (long long)(r + 1) * n;
        walk_m0<false><<<n, 32 * WALK_WARPS, smem, s>>>(
            inv, rows_by, fd, x_cur, m0, n, l, e_fd, super_majority);
        BABBLE_CHECK_LAUNCH();
        walk_close<<<n, 32, 0, s>>>(inv, m0, x_cur, x_next, n, l);
        BABBLE_CHECK_LAUNCH();
    }
    post_table<<<babble_blocks((long long)r_cap * n, 256), 256, 0, s>>>(
        x_hist, rows_by, wtable, last_round, r_cap, n, l);
    BABBLE_CHECK_LAUNCH();
    post_events<<<babble_blocks(e, 256), 256, 0, s>>>(
        x_hist, creator, index, sp_index, rounds, witness, last_round, e, r_cap, n);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// the window's seed: floor and start from the stored history and the
// dirty chains (scal[0] = start), and xs[0] = X(0) or x_hist[start]
__global__ void fw_seed(const int32_t* __restrict__ x_hist,
                        const int32_t* __restrict__ rows_by,
                        const uint8_t* __restrict__ dirty, int32_t* xs, int32_t* scal,
                        int n, int l, int r_cap, int r_win) {
    __shared__ int s_floor;
    if (threadIdx.x == 0) s_floor = r_cap;
    __syncthreads();
    int best = r_cap;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        if (!dirty[c]) continue;
        int cnt = 0;  // X(r)[c] is non-decreasing in r: the first sentinel row
        for (int r = 0; r < r_cap; ++r) cnt += x_hist[(long long)r * n + c] < l;
        best = min(best, cnt);
    }
    best = __reduce_min_sync(BABBLE_FULL_MASK, best);
    if ((threadIdx.x & 31) == 0) atomicMin(&s_floor, best);
    __syncthreads();
    const int floor = babble_clamp(s_floor, 0, r_cap - r_win);
    const int start = max(floor - 1, 0);
    if (threadIdx.x == 0) scal[0] = start;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        xs[c] = floor == 0 ? (rows_by[(long long)c * l] >= 0 ? 0 : l)
                           : x_hist[(long long)start * n + c];
    }
}

// rows start .. start + r_win - 1 of the history from the window's steps,
// and the r_over latch from the step past them
__global__ void fw_place(const int32_t* __restrict__ xs,
                         const int32_t* __restrict__ scal, int32_t* x_hist,
                         uint8_t* r_over, int n, int l, int r_win) {
    const int start = scal[0];
    const long long total = (long long)(r_win + 1) * n;
    int over = 0;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < total;
         k += (long long)gridDim.x * blockDim.x) {
        const int r = (int)(k / n);
        if (r < r_win) x_hist[(long long)start * n + k] = xs[k];
        else over |= xs[k] < l;
    }
    over = __reduce_or_sync(BABBLE_FULL_MASK, over);
    if ((threadIdx.x & 31) == 0 && over) *r_over = 1;  // benign race: every writer stores 1
}

// the voting's witness tables: a warp per (round, chain) slot, lanes over
// the coordinate p
__global__ void fw_tables(const int32_t* __restrict__ wtable,
                          const int32_t* __restrict__ inv,
                          const int32_t* __restrict__ la,
                          const int32_t* __restrict__ index,
                          const uint8_t* __restrict__ coin,
                          int32_t* la_w, int32_t* idx_w, uint8_t* coin_w, int32_t* fd_w,
                          int32_t* wtable_c, int n, int l, int e_cap, int r_cap) {
    const long long slot = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (slot >= (long long)r_cap * n) return;  // warp-uniform
    const int c = (int)(slot % n);
    const int wrow = wtable[slot];
    const bool valid = wrow >= 0;
    const int row = babble_clamp(wrow, 0, e_cap - 1);
    const int idx = valid ? index[row] : BABBLE_MAX_INT32;
    const int v = babble_clamp(idx, 0, l - 1);
    if (lane == 0) {
        idx_w[slot] = idx;
        coin_w[slot] = coin[row];
        wtable_c[slot] = valid ? (int)slot : -1;
    }
    for (int p = lane; p < n; p += 32) {
        la_w[slot * n + p] = la[(long long)row * n + p];
        const int f = inv[((long long)p * n + c) * l + v];
        fd_w[slot * n + p] = (valid && f < l) ? f : BABBLE_MAX_INT32;
    }
}

extern "C" int babble_frontier_window(
    const int32_t* inv, const int32_t* rows_by, const int32_t* x_hist_in,
    const uint8_t* dirty, const int32_t* creator, const int32_t* index,
    const uint8_t* coin, const int32_t* la, int32_t* x_hist, int32_t* xs,
    int32_t* m0, int32_t* scal, uint8_t* r_over, int32_t* rounds, uint8_t* witness,
    int32_t* wtable, int32_t* last_round, int32_t* la_w, int32_t* idx_w,
    uint8_t* coin_w, int32_t* fd_w, int32_t* wtable_c,
    int n, int l, int e_cap, int r_cap, int r_win, int super_majority,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = (size_t)(2 + WALK_WARPS) * n * sizeof(int32_t);
    BABBLE_CHECK(babble_allow_smem(walk_m0<true>, smem));
    BABBLE_CHECK(cudaMemcpyAsync(x_hist, x_hist_in, (size_t)r_cap * n * sizeof(int32_t),
                                 cudaMemcpyDeviceToDevice, s));
    fw_seed<<<1, 1024, 0, s>>>(x_hist_in, rows_by, dirty, xs, scal, n, l, r_cap, r_win);
    BABBLE_CHECK_LAUNCH();
    for (int k = 0; k < r_win; ++k) {
        const int32_t* x_cur = xs + (long long)k * n;
        int32_t* x_next = xs + (long long)(k + 1) * n;
        walk_m0<true><<<n, 32 * WALK_WARPS, smem, s>>>(
            inv, rows_by, nullptr, x_cur, m0, n, l, 1, super_majority);
        BABBLE_CHECK_LAUNCH();
        walk_close<<<n, 32, 0, s>>>(inv, m0, x_cur, x_next, n, l);
        BABBLE_CHECK_LAUNCH();
    }
    const long long xs_total = (long long)(r_win + 1) * n;
    fw_place<<<babble_stride_blocks(xs_total, 256), 256, 0, s>>>(
        xs, scal, x_hist, r_over, n, l, r_win);
    BABBLE_CHECK_LAUNCH();
    post_table<<<babble_blocks((long long)r_cap * n, 256), 256, 0, s>>>(
        x_hist, rows_by, wtable, last_round, r_cap, n, l);
    BABBLE_CHECK_LAUNCH();
    post_events<<<babble_blocks(e_cap, 256), 256, 0, s>>>(
        x_hist, creator, index, nullptr, rounds, witness, last_round, e_cap, r_cap, n);
    BABBLE_CHECK_LAUNCH();
    fw_tables<<<babble_blocks((long long)r_cap * n * 32, 256), 256, 0, s>>>(
        wtable, inv, la, index, coin, la_w, idx_w, coin_w, fd_w, wtable_c, n, l, e_cap,
        r_cap);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// the frontier rows of the local chains: a block per chain, threads over p
__global__ void shard_rows(const int32_t* __restrict__ rows_by,
                           const int32_t* __restrict__ fd,
                           const int32_t* __restrict__ x_cur, int32_t* fd_w,
                           uint8_t* w_ok, int n_p, int l, int e_fd) {
    const int b = blockIdx.x;
    const int x = x_cur[b];
    const bool ok = x < l;
    const int row = babble_clamp(
        max(rows_by[(long long)b * l + babble_clamp(x, 0, l - 1)], 0), 0, e_fd - 1);
    for (int p = threadIdx.x; p < n_p; p += blockDim.x) {
        fd_w[(long long)b * n_p + p] = ok ? fd[(long long)row * n_p + p] : BABBLE_MAX_INT32;
    }
    if (threadIdx.x == 0) w_ok[b] = ok;
}

// m0 of one local chain c (a block) from every frontier row w < n_w
__global__ void shard_m0(const int32_t* __restrict__ inv,
                         const int32_t* __restrict__ fd_w,
                         const uint8_t* __restrict__ w_ok, int32_t* m0_local,
                         int n_w, int n_p, int l, int super_majority) {
    extern __shared__ int32_t smem[];
    int32_t* t = smem;          // (n_w,) t[w] for this chain
    int32_t* ubuf = t + n_w;    // (WALK_WARPS, n_p) one row per warp
    const int c = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int32_t* u = ubuf + (long long)warp * n_p;
    const int32_t* inv_c = inv + (long long)c * n_p * l;
    for (int w = warp; w < n_w; w += WALK_WARPS) {
        if (!w_ok[w]) {  // no frontier row on chain w: every u is L
            if (lane == 0) t[w] = l;
            continue;
        }
        const int32_t* row = fd_w + (long long)w * n_p;
        for (int p = lane; p < n_p; p += 32) {
            const int f = row[p];
            u[p] = f < BABBLE_MAX_INT32 ? inv_c[(long long)p * l + babble_clamp(f, 0, l - 1)]
                                        : l;
        }
        __syncwarp();
        const int tw = warp_select(u, n_p, super_majority, l);
        if (lane == 0) t[w] = tw;
        __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {
        const int m = warp_select(t, n_w, super_majority, l);
        if (lane == 0) m0_local[c] = m;
    }
}

// one warp per local chain c: the closure over the gathered m0 (the first
// n_p entries are the coordinates; the chain's own m0 at c_off + c)
__global__ void shard_close(const int32_t* __restrict__ inv,
                            const int32_t* __restrict__ m0_all,
                            const int32_t* __restrict__ x_cur, int32_t* x_next,
                            int n_p, int l, int c_off) {
    const int c = blockIdx.x;
    const int lane = threadIdx.x;
    int r = l;
    const int32_t* inv_c = inv + (long long)c * n_p * l;
    for (int c2 = lane; c2 < n_p; c2 += 32) {
        const int mc = m0_all[c2];
        if (mc < l) r = min(r, inv_c[(long long)c2 * l + mc]);
    }
    r = __reduce_min_sync(BABBLE_FULL_MASK, r);
    if (lane == 0) {
        const int xn = min(m0_all[c_off + c], r);
        x_next[c] = min(max(xn, x_cur[c]), l);
    }
}

extern "C" int babble_shard_walk_rows(
    const int32_t* rows_by, const int32_t* fd, const int32_t* x_cur, int32_t* fd_w,
    uint8_t* w_ok, int b_rows, int n_p, int l, int e_fd, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    shard_rows<<<b_rows, 128, 0, s>>>(rows_by, fd, x_cur, fd_w, w_ok, n_p, l, e_fd);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

extern "C" int babble_shard_walk_m0(
    const int32_t* inv, const int32_t* fd_w, const uint8_t* w_ok, int32_t* m0_local,
    int b_rows, int n_w, int n_p, int l, int super_majority, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = ((size_t)n_w + (size_t)WALK_WARPS * n_p) * sizeof(int32_t);
    BABBLE_CHECK(babble_allow_smem(shard_m0, smem));
    shard_m0<<<b_rows, 32 * WALK_WARPS, smem, s>>>(inv, fd_w, w_ok, m0_local, n_w, n_p, l,
                                                  super_majority);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

extern "C" int babble_shard_walk_close(
    const int32_t* inv, const int32_t* m0_all, const int32_t* x_cur, int32_t* x_next,
    int b_rows, int n_p, int l, int c_off, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    shard_close<<<b_rows, 32, 0, s>>>(inv, m0_all, x_cur, x_next, n_p, l, c_off);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// The one-launch walk's positions: each one's INV slice (B, N_p, L), chain
// table (B, L), X(0) (B,) and history (r_cap, B), in the order of the
// gathers (axis index), passed by value in the launch's parameters
// (__grid_constant__: indexed in place, never copied per thread).
#define SW_MAX_POS 64
#define SW_THREADS 256
struct SwTable {
    const int32_t* inv[SW_MAX_POS];
    const int32_t* rows_by[SW_MAX_POS];
    const int32_t* x0[SW_MAX_POS];
    int32_t* hist[SW_MAX_POS];
};

// k-th smallest (1-based) of the n values val(0 .. n-1), all in [0, hi];
// every lane of the calling warp returns it: warp_select's count-based
// search, the smallest v with |{val <= v}| >= k (hi if none). The first
// 32 R values are produced once, into registers; any past those are
// produced again at each probe. The search runs over [min, max] of the
// values (max only where k <= n), where its answer lies.
template <int R, typename Val>
__device__ __forceinline__ int sw_select(int n, int k, int hi, Val val) {
    const int lane = threadIdx.x & 31;
    int v[R];
    int mn = BABBLE_MAX_INT32, mx = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int i = j * 32 + lane;
        v[j] = i < n ? val(i) : BABBLE_MAX_INT32;
        if (i < n) {
            mn = min(mn, v[j]);
            mx = max(mx, v[j]);
        }
    }
    for (int i = 32 * R + lane; i < n; i += 32) {
        const int x = val(i);
        mn = min(mn, x);
        mx = max(mx, x);
    }
    int lo = min(__reduce_min_sync(BABBLE_FULL_MASK, mn), hi);
    if (k <= n) hi = min(hi, __reduce_max_sync(BABBLE_FULL_MASK, mx));
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) cnt += v[j] <= mid;
        for (int i = 32 * R + lane; i < n; i += 32) cnt += val(i) <= mid;
        cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
        if (cnt >= k) hi = mid; else lo = mid + 1;
    }
    return lo;
}

// Chain c's frontier row for X[c] = x: where the chain has one (x < L),
// its event row (its fd row, read-only) appended to the step's live list.
__device__ __forceinline__ void sw_live(const int32_t* __restrict__ rows_by_c,
                                        int32_t* live, unsigned int* n_live, int x, int l,
                                        int e_fd) {
    if (x >= l || (threadIdx.x & 31) != 0) return;
    live[atomicAdd(n_live, 1u)] = babble_clamp(
        max(__ldg(rows_by_c + babble_clamp(x, 0, l - 1)), 0), 0, e_fd - 1);
}

// The whole walk, one cooperative launch. Scratch (int32 words): the
// barrier count, moved[r_cap], n_live[r_cap] (zeroed by the launcher),
// then t (N_w, N_w), m0 (N_w) and the live list (N_w). Everything written
// during the launch is read through L2 (__ldcg); INV and fd, read-only,
// through L1 (__ldg). Consecutive warps take consecutive items (c, j) of
// one chain, so that the whole card probes a few chains' INV rows at a
// time, in L2.
template <int R>
__global__ void __launch_bounds__(SW_THREADS, R == 8 ? 4 : 2) sw_grid(
    const __grid_constant__ SwTable tab, const int32_t* __restrict__ fd, int32_t* scratch,
    int n_pos, int b, int n_p, int l, int e_fd, int r_cap, int super_majority) {
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long n_w = (long long)n_pos * b;
    unsigned int* bar = reinterpret_cast<unsigned int*>(scratch);
    unsigned int* moved = bar + 1;
    unsigned int* n_live = moved + r_cap;
    int32_t* t = scratch + 1 + 2 * (long long)r_cap;
    int32_t* m0 = t + n_w * n_w;
    int32_t* live = m0 + n_w;
    unsigned int bar_target = 0;

    // X(0) into row 0 of every history, and its frontier rows
    for (long long c = warp; c < n_w; c += warps) {
        const int pos = (int)(c / b), cb = (int)(c % b);
        const int x = __ldg(tab.x0[pos] + cb);
        if (lane == 0) tab.hist[pos][cb] = x;
        sw_live(tab.rows_by[pos] + (long long)cb * l, live, n_live, x, l, e_fd);
    }
    babble_grid_sync(bar, bar_target);

    for (int r = 0; r + 1 < r_cap; ++r) {
        // A: t[c, j] against the live frontier rows
        const long long nl = *(volatile unsigned int*)(n_live + r);
        for (long long it = warp; it < n_w * nl; it += warps) {
            const long long c = it / nl, j = it % nl;
            const int32_t* inv_c = tab.inv[c / b] + (c % b) * n_p * l;
            const int32_t* row = fd + (long long)__ldcg(live + j) * n_p;
            const int tw = sw_select<R>(n_p, super_majority, l, [&](int p) {
                const int f = __ldg(row + p);
                return f < BABBLE_MAX_INT32
                           ? __ldg(inv_c + (long long)p * l + babble_clamp(f, 0, l - 1))
                           : l;
            });
            if (lane == 0) t[c * n_w + j] = tw;
        }
        babble_grid_sync(bar, bar_target);
        // m0 of every chain
        for (long long c = warp; c < n_w; c += warps) {
            const int32_t* tc = t + c * n_w;
            const int m = sw_select<R>((int)nl, super_majority, l,
                                       [&](int j) { return __ldcg(tc + j); });
            if (lane == 0) m0[c] = m;
        }
        babble_grid_sync(bar, bar_target);
        // B: the closure over the coordinates' m0, X(r+1), the next rows
        for (long long c = warp; c < n_w; c += warps) {
            const int pos = (int)(c / b), cb = (int)(c % b);
            const int32_t* inv_c = tab.inv[pos] + (long long)cb * n_p * l;
            int reach = l;
            for (int c2 = lane; c2 < n_p; c2 += 32) {
                const int mc = __ldcg(m0 + c2);
                if (mc < l) reach = min(reach, __ldg(inv_c + (long long)c2 * l + mc));
            }
            reach = __reduce_min_sync(BABBLE_FULL_MASK, reach);
            int32_t* h = tab.hist[pos];
            const int xc = __ldcg(h + (long long)r * b + cb);
            const int xn = min(max(min(__ldcg(m0 + c), reach), xc), l);
            if (lane == 0) {
                h[(long long)(r + 1) * b + cb] = xn;
                if (xn != xc) atomicAdd(moved + r, 1u);
            }
            sw_live(tab.rows_by[pos] + (long long)cb * l, live, n_live + r + 1, xn, l, e_fd);
        }
        babble_grid_sync(bar, bar_target);
        if (*(volatile unsigned int*)(moved + r) == 0) {
            // the fixed point: rows r + 2 .. r_cap - 1 repeat X(r + 1)
            const long long total = (long long)(r_cap - r - 2) * n_w;
            for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < total;
                 k += (long long)gridDim.x * blockDim.x) {
                const long long c = k % n_w;
                const int row = r + 2 + (int)(k / n_w);
                const int pos = (int)(c / b), cb = (int)(c % b);
                int32_t* h = tab.hist[pos];
                h[(long long)row * b + cb] = __ldcg(h + (long long)(r + 1) * b + cb);
            }
            return;
        }
    }
}

template <int R>
static int sw_launch(const SwTable& tab, const int32_t* fd, int32_t* scratch, int n_pos,
                     int b, int n_p, int l, int e_fd, int r_cap, int super_majority,
                     int device, cudaStream_t s) {
    const long long n_w = (long long)n_pos * b;
    // phase A's items, a warp each, bound the useful block count
    const long long items = (n_w * n_w + SW_THREADS / 32 - 1) / (SW_THREADS / 32);
    int g = 0;
    BABBLE_CHECK(babble_coop_blocks(sw_grid<R>, SW_THREADS, 0, device, items, &g));
    void* args[] = {
        (void*)&tab, (void*)&fd, (void*)&scratch, (void*)&n_pos, (void*)&b, (void*)&n_p,
        (void*)&l, (void*)&e_fd, (void*)&r_cap, (void*)&super_majority,
    };
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)sw_grid<R>, dim3(g),
                                             dim3(SW_THREADS), args, 0, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// ptrs: a host table of int64 device addresses, (4, n_pos): each
// position's INV, chain table, X(0) and history, in gather order.
extern "C" int babble_shard_walk(
    const int64_t* ptrs, const int32_t* fd, int32_t* scratch, int n_pos, int b, int n_p,
    int l, int e_fd, int r_cap, int super_majority, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_pos < 1 || n_pos > SW_MAX_POS) return (int)cudaErrorInvalidValue;
    SwTable tab;
    for (int k = 0; k < n_pos; ++k) {
        tab.inv[k] = reinterpret_cast<const int32_t*>(ptrs[k]);
        tab.rows_by[k] = reinterpret_cast<const int32_t*>(ptrs[n_pos + k]);
        tab.x0[k] = reinterpret_cast<const int32_t*>(ptrs[2 * n_pos + k]);
        tab.hist[k] = reinterpret_cast<int32_t*>(ptrs[3 * n_pos + k]);
    }
    for (int k = n_pos; k < SW_MAX_POS; ++k) {
        tab.inv[k] = tab.rows_by[k] = tab.x0[k] = nullptr;
        tab.hist[k] = nullptr;
    }
    // the barrier count, moved[] and n_live[] start at 0
    BABBLE_CHECK(cudaMemsetAsync(scratch, 0, (1 + 2 * (size_t)r_cap) * sizeof(int32_t), s));
    // 8 values a lane in registers up to 256 chains and coordinates, 32 above
    if ((long long)n_pos * b <= 256 && n_p <= 256) {
        return sw_launch<8>(tab, fd, scratch, n_pos, b, n_p, l, e_fd, r_cap, super_majority,
                            device, s);
    }
    return sw_launch<32>(tab, fd, scratch, n_pos, b, n_p, l, e_fd, r_cap, super_majority,
                         device, s);
}

extern "C" int babble_frontier_post(
    const int32_t* x_hist, const int32_t* rows_by, const int32_t* creator,
    const int32_t* index, const int32_t* sp_index, int32_t* rounds, uint8_t* witness,
    int32_t* wtable, int32_t* last_round, int n, int l, int e, int r_cap,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    post_table<<<babble_blocks((long long)r_cap * n, 256), 256, 0, s>>>(
        x_hist, rows_by, wtable, last_round, r_cap, n, l);
    BABBLE_CHECK_LAUNCH();
    if (e > 0) {
        post_events<<<babble_blocks(e, 256), 256, 0, s>>>(
            x_hist, creator, index, sp_index, rounds, witness, last_round, e, r_cap, n);
        BABBLE_CHECK_LAUNCH();
    }
    return 0;
}
