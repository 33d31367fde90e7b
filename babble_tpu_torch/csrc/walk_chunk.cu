// walk_chunk: `length` seeded round-frontier steps in one launch.
//
// Replaces babble_tpu/tpu/doubling.py:296 _walk_chunk (a lax.scan of the
// contracted frontier step, with :253 _m0_binsearch_from). One step
// X(r) -> X(r+1), r = r_abs[k]:
//   w_ok[w]   = X[w] < l, and (seeded) not (X[w] = 0 and r = first_nw[w]);
//   fd_w[w]   = fd[rows_by[w, X[w]]] where w_ok, else MAX;
//   m0[c]     = a binary search over chain c, from lo = X[c], hi = l, of
//               exactly `steps` probes mid = min((lo + hi) / 2, l - 1) at
//               event rows_by[c, min(mid, len_c - 1)]: the predicate is
//               "strongly sees >= super_majority of the w_ok rows";
//               m0 = hi if hi < len_c else l;
//   X(r+1)[c] = min(m0[c], min over x of INV[c, x, m0[x]] (m0[x] < l)),
//               then min with the seed row (seeded), then
//               min(max(., X(r)[c]), l).
// The search iteration is reproduced as it is, so the integers match in
// every case, including searches that end before they converge.
//
// Bound: the chain of dependent steps. A step needs N*N fd words, up to
// N*steps la rows and N*N INV words, and N*steps*N*N compares: a few
// microseconds of bytes for a whole chunk, but step r+1 starts from X(r+1).
// At 8 validators a step is a few thousand compares and a barrier across
// SMs would cost more than the step; at 256 it is 12 probes x 256 chains
// x 65,536 compares, more than one SM does in microseconds. Two kernels:
//
// walk_chunk_tree, up to 32 validators: one block, a warp per chain,
// after a prep launch that lays la and fd out in chain order (la_by[c, i]
// = la[rows_by[c, i]], fd_by likewise) and counts the chains' lengths, so
// that a probe or a frontier row is one load and not a load behind a load.
// Each step loads the frontier rows into registers, then runs each chain's
// binary search as a speculative tree: from (lo, hi), the warp evaluates
// at once all 2^d - 1 probes the next d iterations could make (d from
// tpu/_ext.py walk_chunk_depth, by width, as measured on the card) and
// takes the d decisions on chip from those verdicts. The iteration is
// reproduced exactly (the clamps, the len > 0 rule, any predicate,
// monotone or not): `steps` probes cost ceil(steps / d) dependent rounds.
// The last round also loads the closure's INV value for every leaf, so
// the closure reads shared memory.
//
// walk_chunk_grid, above: a cooperative launch, a block per chain (as
// many as the card holds at once; a block takes chains c, c + grid, ...)
// and a barrier across the grid between the two halves of a step:
//   search:  block c runs chain c's binary search; per probe it stages the
//            probed la row in shared memory and counts, thread by (four
//            witnesses, a slice of the coordinates), la_mid[p] >=
//            fdT[p, w] over the table, here with rows padded to a
//            multiple of four (16-byte loads of four witnesses; padding
//            columns hold MAX), then sums the slices per witness and the
//            verdicts over the block; it writes m0[c];
//   advance: one warp per chain over the whole grid takes the closure,
//            writes X(r+1)[c] and loads the next step's frontier row c
//            into column c of the table (lanes over p).
// The frontier, m0, the chain lengths and the table live in a device
// scratch the wrapper allocates, read and written through L2 (__ldcg /
// __stcg); the grid barrier's fences order them. Each block copies the
// table into its shared memory after the barrier where it fits (up to
// about 230 validators); past that the probes read it from L2.
//
// Launches per call (one chunk): one (walk_chunk_tree: two, the prep
// launch and the walk).

#include "common.cuh"

// largest dynamic shared memory one block may use on an H100
#define WC_MAX_SMEM 232448
// walk_chunk_tree up to this many validators
#define WC_BLOCK_MAX 32
// walk_chunk_tree's largest tree depth (a round's verdicts fit a 64-bit mask)
#define WC_TREE_DEPTH_MAX 6

// walk_chunk_tree's dynamic shared memory at n validators and tree depth d:
// each chain's probed rows of a round (2^d - 1 rows of NP words) and its
// closure terms by leaf (2^d x n words, rounded up to 4; tpu/_ext.py
// block_smem follows it)
static inline size_t wc_tree_smem(int n, int depth) {
    const size_t nodes = ((size_t)1 << depth) - 1;
    const size_t np = n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
    return (size_t)n * (nodes * np + ((nodes + 1) * n + 3) / 4 * 4) * sizeof(int32_t);
}

// Coordinate slices per quad of witnesses in walk_chunk_grid: the
// block's threads over the quads, each slice at least 8 coordinates long.
__host__ __device__ __forceinline__ int wc_slices(int n, int threads) {
    const int nq = (n + 3) / 4;
    int s = threads >= nq ? threads / nq : 1;
    const int cap = n / 8 > 1 ? n / 8 : 1;
    return s < cap ? s : cap;
}

// Column w of walk_chunk_grid's table and wok[w] for frontier row w at
// index x, round r_cur; one whole warp.
__device__ __forceinline__ void wc_frontier_row(
    int w, int x, int r_cur, const int32_t* __restrict__ rows_by,
    const int32_t* __restrict__ fd, const int32_t* __restrict__ first_nw, int32_t* tab,
    int32_t* wok, int n, int ld4, int l, int e_fd, int use_seeds) {
    const int lane = threadIdx.x & 31;
    bool ok = x < l;
    if (use_seeds) ok = ok && !(x == 0 && r_cur == first_nw[w]);
    const int row = ok ? babble_clamp(
        rows_by[(long long)w * l + babble_clamp(x, 0, l - 1)], 0, e_fd - 1) : 0;
    for (int p = lane; p < n; p += 32) {
        __stcg(tab + (long long)p * ld4 + w, ok ? fd[(long long)row * n + p] : BABBLE_MAX_INT32);
    }
    if (lane == 0) __stcg(wok + w, (int32_t)ok);
}

// The block's counts of la_mid[p] >= fdT[p, 4q .. 4q+3] over its
// slices: thread j takes quad q = j % nq and coordinates p = j / nq, +
// n_slices, ...; part[s * ld4 + w] is slice s's count for witness w.
template <bool SMEM_TAB>
__device__ __forceinline__ void wc_count(const int32_t* tab, const int32_t* la_mid,
                                         int32_t* part, int n, int nq, int n_slices) {
    const int4* tab4 = reinterpret_cast<const int4*>(tab);
    int4* part4 = reinterpret_cast<int4*>(part);
    for (int j = threadIdx.x; j < nq * n_slices; j += blockDim.x) {
        const int q = j % nq;
        int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 4
        for (int p = j / nq; p < n; p += n_slices) {
            const int4 v = SMEM_TAB ? tab4[p * nq + q] : __ldcg(tab4 + (long long)p * nq + q);
            const int lm = la_mid[p];
            c0 += lm >= v.x;
            c1 += lm >= v.y;
            c2 += lm >= v.z;
            c3 += lm >= v.w;
        }
        part4[j] = make_int4(c0, c1, c2, c3);  // j = slice * nq + q
    }
}

// The chain-order tables of the one-block walk: la_by[c, i, :] =
// la[clamp(rows_by[c, i], 0, e_la - 1), :] and fd_by likewise from fd, rows
// of ld words (padding MIN in la_by and MAX in fd_by, which never compare
// true), and each chain's length (its slots that hold a row; len zeroed
// before the launch).
__global__ void wc_tables(const int32_t* __restrict__ rows_by, const int32_t* __restrict__ la,
                          const int32_t* __restrict__ fd, int32_t* la_by, int32_t* fd_by,
                          int32_t* len, int n, int l, int e_la, int e_fd, int ld) {
    const long long total = (long long)n * l * ld;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long k = gtid; k < total; k += stride) {
        const int q = (int)(k % ld);
        const int r = rows_by[k / ld];
        la_by[k] = q < n ? la[(long long)babble_clamp(r, 0, e_la - 1) * n + q]
                         : BABBLE_MIN_INT32;
        fd_by[k] = q < n ? fd[(long long)babble_clamp(r, 0, e_fd - 1) * n + q]
                         : BABBLE_MAX_INT32;
    }
    for (long long s = gtid; s < (long long)n * l; s += stride) {
        const int c = (int)(s / l);
        const unsigned act = __activemask();
        const unsigned peers = __match_any_sync(act, c);
        const unsigned hits = __ballot_sync(act, rows_by[s] >= 0) & peers;
        if ((threadIdx.x & 31) == __ffs(peers) - 1 && hits) atomicAdd(len + c, __popc(hits));
    }
}

// walk_chunk_tree<NP>, up to WC_BLOCK_MAX validators, NP the power of two
// at or above n (at least 4): one block, a warp per chain. A step: each
// lane holds one frontier row (fd_by[w, X[w]], w = lane % NP) in
// registers, so a warp's 32 / NP lane groups each hold every row (up to 8
// validators each lane loads its row; from 16 the block stages each row
// once in shared memory, read after round 0's barrier); the binary search
// runs in rounds of `depth` iterations, and a round stages the probed
// la_by rows of every node of the chain's tree (2^depth - 1, one load each,
// all at once) in the warp's slice of shared memory, counts them against
// the frontier rows (a lane group per node, a ballot per node), gathers
// the verdicts into a bit mask every lane holds and takes the round's
// decisions from it in registers. The last round also stages INV[c',
// chain, m0] for every leaf's m0 and every chain c', so that once its
// decisions are taken the chain hands every chain its closure term
// through shared memory. The step's round number, seed row and first_nw
// are read ahead of the walk. Per step: the search's rounds of dependent
// loads (the first beside the frontier rows') and two block barriers.
template <int NP>
__global__ void __launch_bounds__(NP * 32) walk_chunk_tree(
    const int32_t* __restrict__ inv, const int32_t* __restrict__ chain_len,
    const int32_t* __restrict__ fd_by, const int32_t* __restrict__ la_by,
    const int32_t* __restrict__ x0, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ r_abs, const int32_t* __restrict__ first_nw,
    int32_t* x_last, int32_t* xs, int n, int l, int super_majority, int length, int steps,
    int use_seeds, int depth) {
    constexpr int NV = NP / 4;      // int4 a row (rows of NP words)
    constexpr int SLOTS = 32 / NP;  // lane groups a warp
    constexpr bool STAGE_FD = NP >= 16;
    const int4 none = make_int4(BABBLE_MAX_INT32, BABBLE_MAX_INT32, BABBLE_MAX_INT32,
                                BABBLE_MAX_INT32);
    extern __shared__ int4 wc_smem4[];
    __shared__ int32_t s_x[2][NP];  // the frontier, by step parity
    __shared__ int32_t s_reach[NP][NP + 1];  // [c'][chain]: INV[c', chain, m0[chain]]
    __shared__ int4 s_fd[NP * (NV + 1)];     // the frontier rows, rows padded by 16 bytes
    __shared__ int32_t s_ok[NP];              // countable frontier rows
    __shared__ int32_t s_fnw[NP];
    constexpr int nv = NV;
    const int nodes = (1 << depth) - 1;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int c = tid >> 5;  // this warp's chain
    const int w = lane % NP, slot = lane / NP;
    const unsigned gmask = NP == 32 ? BABBLE_FULL_MASK : ((1u << (NP & 31)) - 1u);
    // this warp's probed rows (nodes rows of nv int4), then its closure
    // terms by leaf ((nodes + 1) x n)
    int4* s_la = wc_smem4 + (long long)c * (nodes * nv + ((nodes + 1) * n + 3) / 4);
    int32_t* s_leaf = reinterpret_cast<int32_t*>(s_la + nodes * nv);
    const int4* la4 = reinterpret_cast<const int4*>(la_by) + (long long)c * l * nv;
    const int4* fd4 = reinterpret_cast<const int4*>(fd_by);

    const int len = chain_len[c];
    const int last = max(len - 1, 0);
    int r_next = length > 0 ? r_abs[0] : 0;
    if (lane == 0) {
        s_x[0][c] = x0[c];
        s_fnw[c] = use_seeds ? first_nw[c] : 0;
    }
    __syncthreads();

    for (int k = 0; k < length; ++k) {
        const int32_t* xc = s_x[k & 1];
        const int r_cur = r_next;
        if (k + 1 < length) r_next = r_abs[k + 1];
        const int seed = use_seeds ? seeds[(long long)k * n + c] : l;
        // the frontier rows: row w in registers (up to 8 validators each
        // lane loads its own; past that the block stages each row once,
        // read after round 0's barrier)
        bool ok = false;
        int4 f[NV];
        if (STAGE_FD) {
            for (int it = tid; it < n * NV; it += blockDim.x) {
                const int w2 = it / NV, v = it - w2 * NV;
                const int x = xc[w2];
                const bool ok2 = x < l && !(use_seeds && x == 0 && r_cur == s_fnw[w2]);
                s_fd[w2 * (NV + 1) + v] =
                    ok2 ? fd4[((long long)w2 * l + babble_clamp(x, 0, l - 1)) * NV + v] : none;
                if (v == 0) s_ok[w2] = ok2;
            }
        } else {
            const int x = w < n ? xc[w] : l;
            ok = w < n && x < l && !(use_seeds && x == 0 && r_cur == s_fnw[w]);
            const int4* src = fd4 + ((long long)w * l + babble_clamp(x, 0, l - 1)) * NV;
#pragma unroll
            for (int j = 0; j < NV; ++j) f[j] = ok ? src[j] : none;
        }
        // chain c's search, `depth` iterations a round
        int lo = babble_clamp(xc[c], 0, l), hi = l;
        int leaf = -1;  // the last round's leaf, once taken
        for (int done = 0; done < steps;) {  // block-uniform
            const int d = min(depth, steps - done);
            const int nodes_r = (1 << d) - 1;
            const bool final_round = done + d == steps;
            for (int it = lane; it < nodes_r * nv; it += 32) {
                const int node = it / nv, v = it - node * nv;
                const int j = node + 1;
                int a = lo, b = hi;
                for (int bit = 30 - __clz(j); bit >= 0; --bit) {  // node j's interval
                    const int mid = min((a + b) / 2, l - 1);
                    if ((j >> bit) & 1) a = mid + 1;
                    else b = min(mid, b);
                }
                const int probe = min(min((a + b) / 2, l - 1), last);
                s_la[it] = la4[(long long)probe * nv + v];
            }
            if (final_round) {  // every leaf's m0 and its closure terms
                for (int it = lane; it < (nodes_r + 1) * n; it += 32) {
                    const int lf = it / n, c2 = it - lf * n;
                    const int j = (nodes_r + 1) + lf;
                    int a = lo, b = hi;
                    for (int bit = d - 1; bit >= 0; --bit) {
                        const int mid = min((a + b) / 2, l - 1);
                        if ((j >> bit) & 1) a = mid + 1;
                        else b = min(mid, b);
                    }
                    const int m0 = b < len ? b : l;
                    s_leaf[it] = m0 < l ? inv[((long long)c2 * n + c) * l + m0] : l;
                }
            }
            if (STAGE_FD && done == 0) {
                __syncthreads();
                ok = w < n && s_ok[w];
#pragma unroll
                for (int j = 0; j < NV; ++j) f[j] = s_fd[w * (NV + 1) + j];
            } else {
                __syncwarp();
            }
            // verdicts: lane group `slot` counts nodes slot, slot + SLOTS, ...
            unsigned long long pmask = 0;
            for (int t0 = 0; t0 < nodes_r; t0 += SLOTS) {  // warp-uniform
                const int node = t0 + slot;
                int cnt = 0;
                if (node < nodes_r && ok) {
                    const int4* row = s_la + node * nv;
#pragma unroll
                    for (int j = 0; j < NV; ++j) {
                        const int4 a = row[j];
                        cnt += (a.x >= f[j].x) + (a.y >= f[j].y) + (a.z >= f[j].z) +
                               (a.w >= f[j].w);
                    }
                }
                const unsigned bal = __ballot_sync(
                    BABBLE_FULL_MASK, node < nodes_r && ok && cnt >= super_majority);
#pragma unroll
                for (int s2 = 0; s2 < SLOTS; ++s2) {
                    const bool sees = __popc((bal >> (s2 * NP)) & gmask) >= super_majority;
                    if (sees && len > 0 && t0 + s2 < nodes_r) pmask |= 1ull << (t0 + s2);
                }
            }
            // the round's decisions
            int j = 1;
            for (int st = 0; st < d; ++st) {
                const int mid = min((lo + hi) / 2, l - 1);
                if ((pmask >> (j - 1)) & 1) {
                    hi = min(mid, hi);
                    j = 2 * j;
                } else {
                    lo = mid + 1;
                    j = 2 * j + 1;
                }
            }
            if (final_round) leaf = j - (nodes_r + 1);
            done += d;
            if (!final_round) __syncwarp();  // the next round restages s_la
        }
        const int m0 = hi < len ? hi : l;
        for (int c2 = lane; c2 < n; c2 += 32) {
            s_reach[c2][c] = leaf >= 0 ? s_leaf[leaf * n + c2] : l;
        }
        __syncthreads();
        // the closure of chain c: lanes over x (each lane group alike)
        int r = w < n ? s_reach[c][w] : l;
#pragma unroll
        for (int off = NP / 2; off > 0; off >>= 1) {
            r = min(r, __shfl_xor_sync(BABBLE_FULL_MASK, r, off));
        }
        if (lane == 0) {
            const int xn = min(max(min(min(m0, r), seed), xc[c]), l);
            xs[(long long)k * n + c] = xn;
            s_x[(k + 1) & 1][c] = xn;
        }
        __syncthreads();
    }
    if (lane == 0) x_last[c] = s_x[length & 1][c];
}

__global__ void walk_chunk_grid(const int32_t* __restrict__ inv,
                                const int32_t* __restrict__ rows_by,
                                const int32_t* __restrict__ fd,
                                const int32_t* __restrict__ la,
                                const int32_t* __restrict__ x0,
                                const int32_t* __restrict__ seeds,
                                const int32_t* __restrict__ r_abs,
                                const int32_t* __restrict__ first_nw,
                                int32_t* x_last, int32_t* xs, int32_t* scratch,
                                int n, int l, int e_fd, int e_la,
                                int super_majority, int length, int steps,
                                int use_seeds, int tab_in_smem) {
    extern __shared__ int4 smem4[];
    __shared__ int s_seen[3];  // the block's verdict sums, three probes in rotation
    const int ld4 = (n + 3) & ~3;
    const int nq = ld4 >> 2;
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const int n_slices = wc_slices(n, blockDim.x);

    // device scratch: the table (n, ld4), the frontier, m0, the countable
    // rows, the chain lengths, the barrier's count
    int32_t* g_tab = scratch;
    int32_t* xc = g_tab + (long long)n * ld4;
    int32_t* m0 = xc + n;
    int32_t* g_wok = m0 + n;
    int32_t* clen = g_wok + n;
    unsigned int* bar = reinterpret_cast<unsigned int*>(clen + n);
    unsigned int bar_target = 0;
    // shared memory: [the table (n, ld4), wok (ld4)] where they fit, then
    // the probe row (ld4) and the slice counts (n_slices, ld4)
    int32_t* s = reinterpret_cast<int32_t*>(smem4);
    int32_t* tab = g_tab;
    int32_t* wok = g_wok;
    if (tab_in_smem) {
        tab = s;
        wok = s + n * ld4;
        s += n * ld4 + ld4;
    }
    int32_t* la_mid = s;
    int32_t* part = s + ld4;

    const int gw = blockIdx.x * n_warps + (threadIdx.x >> 5);
    const int all_warps = gridDim.x * n_warps;
    if (threadIdx.x < 3) s_seen[threadIdx.x] = 0;
    // the padding columns of the table hold MAX
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < (long long)n * (ld4 - n); k += (long long)gridDim.x * blockDim.x) {
        __stcg(g_tab + (k / (ld4 - n)) * ld4 + n + k % (ld4 - n), BABBLE_MAX_INT32);
    }
    // chain lengths, X(0), the first step's frontier rows
    for (int c = gw; c < n; c += all_warps) {
        int cnt = 0;
        for (int i = lane; i < l; i += 32) cnt += rows_by[(long long)c * l + i] >= 0;
        cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
        const int x = x0[c];
        if (lane == 0) {
            __stcg(clen + c, cnt);
            __stcg(xc + c, x);
        }
        wc_frontier_row(c, x, r_abs[0], rows_by, fd, first_nw, g_tab, g_wok, n, ld4, l, e_fd,
                        use_seeds);
    }

    int probe_no = 0;  // block-uniform
    for (int k = 0; k < length; ++k) {
        babble_grid_sync(bar, bar_target);
        if (tab_in_smem) {  // this step's table and countable rows
            const int4* src = reinterpret_cast<const int4*>(g_tab);
            int4* dst = reinterpret_cast<int4*>(tab);
            for (int i = threadIdx.x; i < n * nq; i += blockDim.x) dst[i] = __ldcg(src + i);
            for (int i = threadIdx.x; i < n; i += blockDim.x) wok[i] = __ldcg(g_wok + i);
            __syncthreads();
        }
        // search: m0[c], one block per chain
        for (int c = blockIdx.x; c < n; c += gridDim.x) {
            const int len = __ldcg(clen + c);
            const int last = max(len - 1, 0);
            int lo = babble_clamp(__ldcg(xc + c), 0, l), hi = l;
            for (int st = 0; st < steps; ++st, ++probe_no) {
                const int mid = min((lo + hi) / 2, l - 1);
                const int probe = min(mid, last);
                const int ev = babble_clamp(rows_by[(long long)c * l + probe], 0, e_la - 1);
                for (int p = threadIdx.x; p < n; p += blockDim.x) {
                    la_mid[p] = la[(long long)ev * n + p];
                }
                // every thread has read the sum this slot held three probes ago
                if (threadIdx.x == 0) s_seen[(probe_no + 1) % 3] = 0;
                __syncthreads();
                if (tab_in_smem) {
                    wc_count<true>(tab, la_mid, part, n, nq, n_slices);
                } else {
                    wc_count<false>(tab, la_mid, part, n, nq, n_slices);
                }
                __syncthreads();
                int seen = 0;
                for (int w = threadIdx.x; w < n; w += blockDim.x) {
                    int cnt = 0;
                    for (int t = 0; t < n_slices; ++t) cnt += part[t * ld4 + w];
                    const int ok = tab_in_smem ? wok[w] : __ldcg(g_wok + w);
                    seen += ok != 0 && cnt >= super_majority;
                }
                seen = __reduce_add_sync(BABBLE_FULL_MASK, seen);
                if (lane == 0 && seen) atomicAdd(&s_seen[probe_no % 3], seen);
                __syncthreads();
                if (s_seen[probe_no % 3] >= super_majority && len > 0) hi = min(mid, hi);
                else lo = mid + 1;
            }
            if (threadIdx.x == 0) __stcg(m0 + c, hi < len ? hi : l);
        }
        babble_grid_sync(bar, bar_target);
        // advance: cross-chain closure, seed row, clamp, then the next
        // step's frontier row; chain c's warp alone reads and writes xc[c]
        for (int c = gw; c < n; c += all_warps) {
            int r = l;
            const int32_t* inv_c = inv + (long long)c * n * l;
            for (int x = lane; x < n; x += 32) {
                const int mx = __ldcg(m0 + x);
                if (mx < l) r = min(r, inv_c[(long long)x * l + babble_clamp(mx, 0, l - 1)]);
            }
            r = __reduce_min_sync(BABBLE_FULL_MASK, r);
            int xn = min(__ldcg(m0 + c), r);
            if (use_seeds) xn = min(xn, seeds[(long long)k * n + c]);
            xn = min(max(xn, __ldcg(xc + c)), l);
            __syncwarp();
            if (lane == 0) {
                xs[(long long)k * n + c] = xn;
                __stcg(xc + c, xn);
                if (k == length - 1) x_last[c] = xn;
            }
            if (k + 1 < length) {
                wc_frontier_row(c, xn, r_abs[k + 1], rows_by, fd, first_nw, g_tab, g_wok, n,
                                ld4, l, e_fd, use_seeds);
            }
        }
    }
}

// walk_chunk_grid's launch shape for n validators: threads per block,
// whether the table is kept in shared memory, and the block's dynamic
// shared memory (tpu/_ext.py smem_bytes follows it).
static void wc_grid_shape(int n, int* threads, int* tab_in_smem, size_t* smem) {
    const int ld4 = (n + 3) & ~3;
    int warps = (n + 15) / 16;
    *threads = 32 * (warps > 16 ? 16 : warps);
    const size_t own = (size_t)ld4 + (size_t)wc_slices(n, *threads) * ld4;
    const size_t table = (size_t)n * ld4 + ld4;
    *tab_in_smem = (own + table) * sizeof(int32_t) <= WC_MAX_SMEM;
    *smem = (own + (*tab_in_smem ? table : 0)) * sizeof(int32_t);
}

// walk_chunk_tree<NP>'s launch: the chain-order tables (rows of NP words)
// and the chain lengths, then the walk.
template <int NP>
static int wc_tree_launch(const int32_t* inv, const int32_t* rows_by, const int32_t* fd,
                          const int32_t* la, const int32_t* x0, const int32_t* seeds,
                          const int32_t* r_abs, const int32_t* first_nw, int32_t* x_last,
                          int32_t* xs, int32_t* scratch, int n, int l, int e_fd, int e_la,
                          int super_majority, int length, int steps, int use_seeds, int depth,
                          cudaStream_t s) {
    int32_t* la_by = scratch;
    int32_t* fd_by = scratch + (long long)n * l * NP;
    int32_t* len = fd_by + (long long)n * l * NP;
    BABBLE_CHECK(cudaMemsetAsync(len, 0, (size_t)n * sizeof(int32_t), s));
    wc_tables<<<babble_stride_blocks((long long)n * l * NP, 256), 256, 0, s>>>(
        rows_by, la, fd, la_by, fd_by, len, n, l, e_la, e_fd, NP);
    BABBLE_CHECK_LAUNCH();
    const size_t smem = wc_tree_smem(n, depth);
    BABBLE_CHECK(babble_allow_smem(walk_chunk_tree<NP>, smem));
    walk_chunk_tree<NP><<<1, 32 * n, smem, s>>>(
        inv, len, fd_by, la_by, x0, seeds, r_abs, first_nw, x_last, xs, n, l,
        super_majority, length, steps, use_seeds, depth);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

extern "C" int babble_walk_chunk(
    const int32_t* inv, const int32_t* rows_by, const int32_t* fd,
    const int32_t* la, const int32_t* x0, const int32_t* seeds,
    const int32_t* r_abs, const int32_t* first_nw, int32_t* x_last,
    int32_t* xs, int32_t* scratch, int n, int l, int e_fd, int e_la,
    int super_majority, int length, int steps, int use_seeds, int depth, int device,
    void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= WC_BLOCK_MAX) {
        if (depth < 1 || depth > WC_TREE_DEPTH_MAX || wc_tree_smem(n, depth) > WC_MAX_SMEM) {
            return (int)cudaErrorInvalidValue;
        }
        if (n <= 4) {
            return wc_tree_launch<4>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last,
                                     xs, scratch, n, l, e_fd, e_la, super_majority, length,
                                     steps, use_seeds, depth, s);
        }
        if (n <= 8) {
            return wc_tree_launch<8>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last,
                                     xs, scratch, n, l, e_fd, e_la, super_majority, length,
                                     steps, use_seeds, depth, s);
        }
        if (n <= 16) {
            return wc_tree_launch<16>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw,
                                      x_last, xs, scratch, n, l, e_fd, e_la, super_majority,
                                      length, steps, use_seeds, depth, s);
        }
        return wc_tree_launch<32>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last,
                                  xs, scratch, n, l, e_fd, e_la, super_majority, length,
                                  steps, use_seeds, depth, s);
    }
    int threads = 0, tab_in_smem = 0;
    size_t smem = 0;
    wc_grid_shape(n, &threads, &tab_in_smem, &smem);
    if (smem > WC_MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            walk_chunk_grid, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    }
    // a block per chain, as many as can be resident at once (the grid
    // barrier needs every block running)
    int per_sm = 0, sms = 0;
    BABBLE_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, walk_chunk_grid, threads, smem));
    BABBLE_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    int grid = per_sm * sms;
    if (grid > n) grid = n;
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int ld4 = (n + 3) & ~3;
    unsigned int* bar = reinterpret_cast<unsigned int*>(scratch + (long long)n * ld4 + 4LL * n);
    BABBLE_CHECK(cudaMemsetAsync(bar, 0, sizeof(unsigned int), s));
    void* args[] = {
        (void*)&inv, (void*)&rows_by, (void*)&fd, (void*)&la, (void*)&x0,
        (void*)&seeds, (void*)&r_abs, (void*)&first_nw, (void*)&x_last,
        (void*)&xs, (void*)&scratch, (void*)&n, (void*)&l, (void*)&e_fd,
        (void*)&e_la, (void*)&super_majority, (void*)&length, (void*)&steps,
        (void*)&use_seeds, (void*)&tab_in_smem,
    };
    BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)walk_chunk_grid, dim3(grid),
                                             dim3(threads), args, smem, s));
    BABBLE_CHECK_LAUNCH();
    return 0;
}
