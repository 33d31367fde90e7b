// The round-frontier DivideRounds walk on one card, and its post pass.
//
// Replaces babble_tpu/tpu/frontier.py:299 _frontier_rounds (make_walk_step
// with _m0_einsum_sort / _m0_binsearch, frontier_x0 and frontier_post), the
// walk half of babble_tpu/tpu/frontier_live.py:184 _decide, and
// babble_tpu/tpu/sharded.py:549 local_walk.
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
// an (N, N, N) tensor, or finds m0 by a binary search over each chain's
// events; here INV is read by direct int32 loads and both selections are
// count-based searches done by one warp each (a warp-wide count per probe),
// so nothing N^3-sized is stored and the integers equal the sort form's
// and the binary search's at every N (both find the first chain index
// seeing a supermajority of the frontier rows, by lastAncestors or by the
// INV built from them).
//
// walk_grid walks the whole frontier in ONE cooperative launch over every
// chain: the steps are phases separated by grid barriers, their exchanges
// reads of a scratch in L2. A step X(r) -> X(r+1):
//   A  t[c, j] for every chain c and every live frontier row j (X(r)[w] <
//      L), a warp each: the super_majority-th smallest over p of
//      INV_c[p, f[j, p]], f[j] the row's first descendants, staged in the
//      scratch and read coalesced; rows with X(r)[w] = L have t = L, and a
//      selection's probes stay below L, so they never count and are left
//      out;
//   -- barrier; m0[c], a warp per chain: the super_majority-th smallest of
//      t[c, :] (L where fewer rows are live);
//   -- barrier; B  the closure of each chain over the coordinates' m0,
//      X(r+1) into the history, a count of the chains that moved, and the
//      chain's next frontier row staged (frow[slot], a slot on the row's
//      count of live rows);
//   -- barrier. When no chain moved, X(r+1) = X(r): F depends on X alone,
//      so every later row repeats it; the blocks fill the history's
//      remaining rows and return. The history equals the full-length walk
//      row for row.
// Two policies make the kernel template (Walk):
//   the frontier rows' source: the fd row of the chain's event
//      rows_by[c, X[c]] (K2, B24), copied coalesced, or the row gathered
//      from INV for the frontier-live engine, which keeps no fd matrix
//      (K15; fd[e, p] == INV[p, creator(e), index(e)]): frow[slot, p] =
//      INV[p, c, X(r+1)[c]] (MAX where that is L), N strided loads a chain
//      and step, where phase A would take N for every item;
//   the positions: one (K2, K15), or a device mesh's, each a slice of B
//      chains with its own INV slice, chain table, X(0) and history, whose
//      addresses lie in a (4, n_pos) table in device memory (any count).
// Each selection keeps its values in registers (32 R of them a warp, R =
// 8 up to 256 chains and coordinates, 32 above; any past those are
// produced again at each probe), and searches [min, max] of the values,
// not [0, L]: the same integers as warp_select. Shared memory: none, at
// every width. Bound: bytes, the frontier rows and the INV values the
// working steps probe. In practice phase A is bound by L1's rate in cache
// lines: a warp's gather of INV_c[p, f] over 32 coordinates touches 32
// lines (N_w x live rows x N_p of them a step), and the frontier rows'
// values on one coordinate lie too far apart to share lines.
//
// The entry points:
//   babble_frontier_rounds (K2): one position, fd rows; X(0) (every
//     non-empty chain at index 0) is the walk's first phase. Then
//     post_table and post_events. 3 launches a call, besides the memset
//     of the scratch's counters.
//   babble_frontier_window (K15, the walk half of the frontier-live
//     engine's decide), one position, rows gathered from INV, over the
//     maintained tables (INV, rows_by, the stored frontier history x_hist,
//     the dirty chains). The walk's first phase copies x_hist and finds
//       floor = min over dirty chains of |{r : x_hist[r, c] < L}| (R_cap if
//               none), clipped to [0, R_cap - r_win]; start = max(floor - 1, 0);
//     then the seed X(0) if floor = 0, else x_hist[start], and r_win steps
//     from it into rows start .. start + r_win - 1 of the copy; r_over
//     latches when X(start + r_win) still holds a row. Then post_table,
//     post_events (sp_index = index - 1) and fw_tables, the witness tables
//     of the voting: la_w[r, c] = la[row], idx_w (MAX where absent),
//     coin_w, fd_w[r, c, p] = INV[p, c, idx_w[r, c]] (MAX where absent or
//     L), and the compact table wtable_c[r, c] = r N + c (-1 where absent)
//     through which decide_fame and round_received read them. 4 launches
//     a call, besides the memset.
//   babble_shard_walk (B24): the device mesh (INV and the chain table
//     sharded over chains, each position owning B chains, fd and la
//     replicated) with every position on one card, fd rows, X(0) from
//     each position, the history into each position's; the all-gathers of
//     frontier rows and m0 become reads of the scratch. 1 launch a call,
//     besides the memset and the copy of the address table.
//
// Positions on distinct cards walk the same frontier step by step, with
// the frontier rows and m0 crossing the mesh by two tiled all-gathers per
// step. Three launches per step per position:
//   shard_rows   fd_w_local[b, p] = fd[rows_by[b, X[b]], p] (MAX where X[b]
//                = L) and w_ok[b] = X[b] < L, a block per local chain;
//   shard_m0     m0_local[c] from the gathered (N_w, N_p) frontier rows and
//                the local INV slice, warp_select's count-based selection
//                fed the rows directly;
//   shard_close  the closure of the local chains over the gathered m0,
//                its coordinates cut to the real width N_p, writing X(r+1).
// babble_frontier_post launches post_table and post_events alone: the
// witness table and the events' rounds from the gathered history
// (sharded.py:691). Bound: bytes; each step reads the frontier rows' fd
// (N_w x N_p int32) and one INV value per (chain, coordinate) probed.

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

// ---------------------------------------------------------------------------
// The cooperative walk (walk_grid) and its policies
// ---------------------------------------------------------------------------

#define SW_THREADS 256

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


// Each policy names chain c's INV slice (N_p, L) and chain table (L,), the
// history cell of row r, X(0), and what its launch does before the walk
// (begin, which may end in a grid barrier and returns where the walk lies
// in the history) and after it (end, given the live rows of the last
// row). FROM_INV: the frontier rows come from INV (first_desc), not from fd.
// The policy stays in the launch's parameters (__grid_constant__), out of
// the registers that the selections need.

// Where a walk lies in its history, found by begin: the window's floor
// and first row (K15; 0 for the others)
struct WalkAt {
    int floor, start;
};

// B24: n_pos positions of b chains each, in gather order; ptrs (4, n_pos)
// int64 in device memory: each position's INV slice, chain table, X(0) and
// history (r_cap, b)
struct WalkMesh {
    static constexpr bool FROM_INV = false;
    const long long* ptrs;
    int n_pos, b, n_p, l;

    // chain c's position and its place there (N_w < 2^31)
    __device__ __forceinline__ const int32_t* at(int k, long long c) const {
        return reinterpret_cast<const int32_t*>(__ldg(ptrs + k * n_pos + (int)c / b));
    }
    __device__ __forceinline__ int cb(long long c) const { return (int)c % b; }
    __device__ __forceinline__ const int32_t* inv(long long c) const {
        return at(0, c) + (long long)cb(c) * n_p * l;
    }
    __device__ __forceinline__ const int32_t* rows_by(long long c) const {
        return at(1, c) + (long long)cb(c) * l;
    }
    __device__ __forceinline__ int x0(long long c, WalkAt) const {
        return __ldg(at(2, c) + cb(c));
    }
    __device__ __forceinline__ int32_t* hist(int r, long long c, WalkAt) const {
        return const_cast<int32_t*>(at(3, c)) + (long long)r * b + cb(c);
    }
    __device__ __forceinline__ WalkAt begin(unsigned int*, unsigned int*, unsigned int&) const {
        return {0, 0};
    }
    __device__ __forceinline__ void end(unsigned int) const {}
};

// K2: one position of n chains; X(0): every non-empty chain at index 0
// (base grids); the history (r_cap, n)
struct WalkRounds {
    static constexpr bool FROM_INV = false;
    const int32_t* inv_;
    const int32_t* rows_by_;
    int32_t* x_hist;
    int n, l;

    __device__ __forceinline__ const int32_t* inv(long long c) const {
        return inv_ + c * n * l;
    }
    __device__ __forceinline__ const int32_t* rows_by(long long c) const {
        return rows_by_ + c * l;
    }
    __device__ __forceinline__ int x0(long long c, WalkAt) const {
        return __ldg(rows_by_ + c * l) >= 0 ? 0 : l;
    }
    __device__ __forceinline__ int32_t* hist(int r, long long c, WalkAt) const {
        return x_hist + (long long)r * n + c;
    }
    __device__ __forceinline__ WalkAt begin(unsigned int*, unsigned int*, unsigned int&) const {
        return {0, 0};
    }
    __device__ __forceinline__ void end(unsigned int) const {}
};

// K15: one position of n chains over the frontier-live tables. begin
// copies the stored history into x_hist and finds the window's floor and
// start (the key word holds max over dirty chains of r_cap - |{r : x < L}|,
// 0 for none); the walk's rows 0 .. r_win - 1 are the copy's rows start ..
// start + r_win - 1, its row r_win (X(start + r_win)) lies in `last`; end
// latches r_over when that row holds a frontier row.
struct WalkWindow {
    static constexpr bool FROM_INV = true;
    const int32_t* inv_;
    const int32_t* rows_by_;
    const int32_t* x_hist_in;
    const uint8_t* dirty;
    const uint8_t* r_over_in;
    int32_t* x_hist;
    int32_t* last;
    uint8_t* r_over;
    int n, l, r_cap, r_win;

    __device__ __forceinline__ const int32_t* inv(long long c) const {
        return inv_ + c * n * l;
    }
    __device__ __forceinline__ const int32_t* rows_by(long long c) const {
        return rows_by_ + c * l;
    }
    __device__ __forceinline__ int x0(long long c, WalkAt at) const {
        return at.floor == 0 ? (__ldg(rows_by_ + c * l) >= 0 ? 0 : l)
                             : __ldg(x_hist_in + (long long)at.start * n + c);
    }
    __device__ __forceinline__ int32_t* hist(int r, long long c, WalkAt at) const {
        return r < r_win ? x_hist + (long long)(at.start + r) * n + c : last + c;
    }
    // fd[e, p] of chain c's event at index x: INV[p, c, x], MAX where L
    __device__ __forceinline__ int first_desc(long long c, int p, int x) const {
        const int v = __ldg(inv_ + ((long long)p * n + c) * l + x);
        return v < l ? v : BABBLE_MAX_INT32;
    }
    __device__ __forceinline__ WalkAt begin(unsigned int* key, unsigned int* bar,
                                            unsigned int& bar_target) const {
        const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
        const long long threads = (long long)gridDim.x * blockDim.x;
        for (long long k = tid; k < (long long)r_cap * n; k += threads) {
            x_hist[k] = __ldg(x_hist_in + k);
        }
        int best = 0;
        for (long long c = tid; c < n; c += threads) {
            if (!dirty[c]) continue;
            int cnt = 0;  // X(r)[c] is non-decreasing in r: the first sentinel row
            for (int r = 0; r < r_cap; ++r) cnt += __ldg(x_hist_in + (long long)r * n + c) < l;
            best = max(best, r_cap - cnt);
        }
        best = __reduce_max_sync(BABBLE_FULL_MASK, best);
        if ((threadIdx.x & 31) == 0 && best > 0) atomicMax(key, (unsigned int)best);
        babble_grid_sync(bar, bar_target);
        const int floor =
            babble_clamp(r_cap - (int)*(volatile unsigned int*)key, 0, r_cap - r_win);
        return {floor, max(floor - 1, 0)};
    }
    __device__ __forceinline__ void end(unsigned int live_last) const {
        if (blockIdx.x == 0 && threadIdx.x == 0) *r_over = *r_over_in | (live_last > 0u);
    }
};

// Chain c's frontier row for X[c] = x: where the chain has one (x < L), a
// slot on the row's count n_live and, where the next step reads it
// (`stage`), the row's first descendants in frow[slot]: its event's fd
// row, or (FROM_INV) gathered from INV. x is warp-uniform.
template <typename Walk>
__device__ __forceinline__ void walk_row(const Walk& w, const int32_t* __restrict__ fd,
                                         long long c, int x, int l, int e_fd, int n_p,
                                         int32_t* frow, unsigned int* n_live, bool stage) {
    if (x >= l) return;
    const int lane = threadIdx.x & 31;
    unsigned int slot = 0;
    if (lane == 0) slot = atomicAdd(n_live, 1u);
    if (!stage) return;
    slot = __shfl_sync(BABBLE_FULL_MASK, slot, 0);
    int32_t* row = frow + (long long)slot * n_p;
    if constexpr (Walk::FROM_INV) {
        for (int p = lane; p < n_p; p += 32) row[p] = w.first_desc(c, p, x);
    } else {
        const int32_t* src =
            fd + (long long)babble_clamp(max(__ldg(w.rows_by(c) + x), 0), 0, e_fd - 1) * n_p;
        for (int p = lane; p < n_p; p += 32) row[p] = __ldg(src + p);
    }
}

// Int32 words of the scratch the launcher zeroes: the barrier count,
// moved[n_steps], n_live[n_steps + 1] and the policy's key word.
__host__ __device__ __forceinline__ long long walk_zero_words(int n_steps) {
    return 3 + 2 * (long long)n_steps;
}

// The whole walk, one cooperative launch: n_steps steps from X(0) into
// rows 0 .. n_steps of the history. Scratch (int32 words): the zeroed
// counters (walk_zero_words), then t (N_w, N_w), m0 (N_w) and the staged
// frontier rows frow (N_w, N_p). Staging each row once a step (fd rows
// too) keeps phase A one loop for every policy and its selection within
// 128 registers at R = 32: reading fd rows through a list of events
// there spilled. Everything written during the launch is read through L2
// (__ldcg); the read-only tables through L1 (__ldg).
// Consecutive warps take consecutive items (c, j) of one chain, so that
// the whole card probes a few chains' INV rows at a time, in L2.
template <int R, typename Walk>
__global__ void __launch_bounds__(SW_THREADS, R == 8 ? 4 : 2) walk_grid(
    const __grid_constant__ Walk w, const int32_t* __restrict__ fd, int32_t* scratch, int n_w_,
    int n_p, int l, int e_fd, int n_steps, int super_majority) {
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long n_w = n_w_;
    unsigned int* bar = reinterpret_cast<unsigned int*>(scratch);
    unsigned int* moved = bar + 1;
    unsigned int* n_live = moved + n_steps;
    unsigned int* key = n_live + n_steps + 1;
    int32_t* t = scratch + walk_zero_words(n_steps);
    int32_t* m0 = t + n_w * n_w;
    int32_t* frow = m0 + n_w;
    unsigned int bar_target = 0;
    const WalkAt at = w.begin(key, bar, bar_target);

    // X(0) into row 0, and its frontier rows
    for (long long c = warp; c < n_w; c += warps) {
        const int x = w.x0(c, at);
        if (lane == 0) *w.hist(0, c, at) = x;
        walk_row(w, fd, c, x, l, e_fd, n_p, frow, n_live, n_steps > 0);
    }
    babble_grid_sync(bar, bar_target);

    for (int r = 0; r < n_steps; ++r) {
        // A: t[c, j] against the live frontier rows
        const long long nl = *(volatile unsigned int*)(n_live + r);
        for (long long it = warp; it < n_w * nl; it += warps) {
            const long long c = it / nl, j = it % nl;
            const int32_t* inv_c = w.inv(c);
            const int32_t* row = frow + j * n_p;
            const int tw = sw_select<R>(n_p, super_majority, l, [&](int p) {
                const int f = __ldcg(row + p);
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
            const int32_t* inv_c = w.inv(c);
            int reach = l;
            for (int c2 = lane; c2 < n_p; c2 += 32) {
                const int mc = __ldcg(m0 + c2);
                if (mc < l) reach = min(reach, __ldg(inv_c + (long long)c2 * l + mc));
            }
            reach = __reduce_min_sync(BABBLE_FULL_MASK, reach);
            const int xc = __ldcg(w.hist(r, c, at));
            const int xn = min(max(min(__ldcg(m0 + c), reach), xc), l);
            if (lane == 0) {
                *w.hist(r + 1, c, at) = xn;
                if (xn != xc) atomicAdd(moved + r, 1u);
            }
            walk_row(w, fd, c, xn, l, e_fd, n_p, frow, n_live + r + 1, r + 1 < n_steps);
        }
        babble_grid_sync(bar, bar_target);
        if (*(volatile unsigned int*)(moved + r) == 0) {
            // the fixed point: rows r + 2 .. n_steps repeat X(r + 1)
            w.end(*(volatile unsigned int*)(n_live + r + 1));
            const long long total = (long long)(n_steps - r - 1) * n_w;
            for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < total;
                 k += (long long)gridDim.x * blockDim.x) {
                const long long c = k % n_w;
                *w.hist(r + 2 + (int)(k / n_w), c, at) = __ldcg(w.hist(r + 1, c, at));
            }
            return;
        }
    }
    w.end(*(volatile unsigned int*)(n_live + n_steps));
}

template <int R, typename Walk>
static int walk_launch_r(const Walk& walk, const int32_t* fd, int32_t* scratch, int n_w,
                         int n_p, int l, int e_fd, int n_steps, int super_majority,
                         int device, cudaStream_t s) {
    // phase A's items, a warp each, bound the useful block count
    const long long items =
        ((long long)n_w * n_w + SW_THREADS / 32 - 1) / (SW_THREADS / 32);
    int g = 0;
    BABBLE_CHECK(babble_coop_blocks(walk_grid<R, Walk>, SW_THREADS, 0, device, items, &g));
    void* args[] = {
        (void*)&walk, (void*)&fd, (void*)&scratch, (void*)&n_w, (void*)&n_p, (void*)&l,
        (void*)&e_fd, (void*)&n_steps, (void*)&super_majority,
    };
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)walk_grid<R, Walk>, dim3(g),
                                             dim3(SW_THREADS), args, 0, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// The walk's counters zeroed, then one launch: 8 values a lane in
// registers up to 256 chains and coordinates, 32 above.
template <typename Walk>
static int walk_launch(const Walk& walk, const int32_t* fd, int32_t* scratch, int n_w, int n_p,
                       int l, int e_fd, int n_steps, int super_majority, int device,
                       cudaStream_t s) {
    BABBLE_CHECK(cudaMemsetAsync(scratch, 0, walk_zero_words(n_steps) * sizeof(int32_t), s));
    if (n_w <= 256 && n_p <= 256) {
        return walk_launch_r<8>(walk, fd, scratch, n_w, n_p, l, e_fd, n_steps, super_majority,
                                device, s);
    }
    return walk_launch_r<32>(walk, fd, scratch, n_w, n_p, l, e_fd, n_steps, super_majority,
                             device, s);
}

// scratch: 3 + 2 (r_cap - 1) + 2 n^2 + n int32 words (tpu/_ext.py
// walk_scratch_words)
extern "C" int babble_frontier_rounds(
    const int32_t* inv, const int32_t* rows_by, const int32_t* creator,
    const int32_t* index, const int32_t* sp_index, const int32_t* fd,
    int32_t* x_hist, int32_t* scratch, int32_t* rounds, uint8_t* witness,
    int32_t* wtable, int32_t* last_round,
    int n, int l, int e, int e_fd, int super_majority, int r_cap,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const WalkRounds walk{inv, rows_by, x_hist, n, l};
    const int err = walk_launch(walk, fd, scratch, n, n, l, e_fd, r_cap - 1, super_majority,
                                device, s);
    if (err) return err;
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

// scratch: 3 + 2 r_win + 2 n^2 + 2 n int32 words (walk_scratch_words with
// the walk's last row)
extern "C" int babble_frontier_window(
    const int32_t* inv, const int32_t* rows_by, const int32_t* x_hist_in,
    const uint8_t* dirty, const int32_t* creator, const int32_t* index,
    const uint8_t* coin, const int32_t* la, const uint8_t* r_over_in, int32_t* x_hist,
    int32_t* scratch, uint8_t* r_over, int32_t* rounds, uint8_t* witness,
    int32_t* wtable, int32_t* last_round, int32_t* la_w, int32_t* idx_w,
    uint8_t* coin_w, int32_t* fd_w, int32_t* wtable_c,
    int n, int l, int e_cap, int r_cap, int r_win, int super_majority,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int32_t* last = scratch + walk_zero_words(r_win) + 2 * (long long)n * n + n;
    const WalkWindow walk{inv, rows_by, x_hist_in, dirty, r_over_in, x_hist, last, r_over,
                          n, l, r_cap, r_win};
    const int err = walk_launch(walk, nullptr, scratch, n, n, l, 1, r_win, super_majority,
                                device, s);
    if (err) return err;
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

// ptrs: (4, n_pos) int64 device addresses in device memory, each
// position's INV, chain table, X(0) and history, in gather order; any
// number of positions. scratch: walk_scratch_words(n_pos b, n_p, r_cap - 1)
extern "C" int babble_shard_walk(
    const int64_t* ptrs, const int32_t* fd, int32_t* scratch, int n_pos, int b, int n_p,
    int l, int e_fd, int r_cap, int super_majority, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_pos < 1 || b < 1) return (int)cudaErrorInvalidValue;
    const WalkMesh walk{reinterpret_cast<const long long*>(ptrs), n_pos, b, n_p, l};
    return walk_launch(walk, fd, scratch, n_pos * b, n_p, l, e_fd, r_cap - 1, super_majority,
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
