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

// one block per chain c: m0[c] from the frontier X(r)
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
        int row = babble_clamp(rows_by[(long long)w * l + x], 0, e_fd - 1);
        const int32_t* fd_row = fd + (long long)row * n;
        for (int p = lane; p < n; p += 32) {
            int f = fd_row[p];
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
        int idx = index[k], spi = sp_index[k];
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
    if (smem > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            walk_m0, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    }
    walk_x0<<<babble_blocks(n, 128), 128, 0, s>>>(rows_by, x_hist, n, l);
    BABBLE_CHECK_LAUNCH();
    for (int r = 0; r + 1 < r_cap; ++r) {
        const int32_t* x_cur = x_hist + (long long)r * n;
        int32_t* x_next = x_hist + (long long)(r + 1) * n;
        walk_m0<<<n, 32 * WALK_WARPS, smem, s>>>(
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
