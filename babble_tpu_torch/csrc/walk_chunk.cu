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
// x 65,536 compares, more than one SM does in microseconds. Three forms,
// chosen by width (and chain length) by tpu/_ext.py walk_chunk_plan, which
// hands the launcher its form, cluster size, column slice, chains a block,
// probe rows, threads and shared memory:
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
// walk_chunk_cluster, from 33 validators below WC_L2_FROM, while a cluster
// holds the step's frontier table: a launch of thread-block clusters of k
// blocks (k <= 8, a portable cluster), every block resident (a software
// barrier across the grid), two barriers across the grid a searched step:
//   search:  the table fdT[p, w] (N coordinates x the witness columns
//            padded to k * cw) lies in the cluster's shared memory, split
//            by witness columns: block r of a cluster holds columns
//            [r * cw, (r + 1) * cw), one bulk copy (cp.async.bulk) a step
//            from a device copy laid out slice by slice. A cluster takes
//            `chains` chains at a time (chains c0 .. c0 + chains - 1, the
//            next group `clusters` groups on), their rows_by rows staged in
//            shared memory, and runs their searches together as
//            speculative trees of depth d (walk_chunk_depth): a round
//            stages the la rows of every node of every chain's tree
//            (2^d - 1 each), each block counts them against its columns
//            (a thread a quad of columns and a range of coordinates, four
//            probes at a time in registers, the ranges summed in shared
//            memory), sums each node's verdicts over its columns, and the
//            cluster adds the k blocks' sums through distributed shared
//            memory behind one cluster barrier (two buffers in rotation,
//            so one barrier a round; a block's own sums where k = 1).
//            Every block then takes the same d decisions, reading each
//            node's sums as it goes: four barriers a round in all. Block 0
//            of the cluster writes m0[c];
//   advance: one warp per chain over the whole grid takes the closure,
//            writes X(r+1)[c] and the next step's frontier row c into
//            column c of the device table (lanes over p).
// Per step the table crosses L2 once per block (not once per probe), and
// a probe's event row is a shared-memory read.
//
// walk_chunk_tiles, from tpu/_ext.py WC_L2_FROM validators or past a
// cluster's reach: one cooperative launch that counts every chain's
// probes of a search round together, tile by tile:
//   table:   the step's frontier rows with the countable ones compacted:
//            the advance gives each countable row a slot (the atomic that
//            counts them) and writes its fd row there, rows of ld4 words
//            in device memory; the count is a sum over witnesses, so the
//            order of the slots changes nothing;
//   round:   rows (chain, node) of the probes' la rows (2^d - 1 nodes a
//            chain, the tree of walk_chunk_depth's depth for this form)
//            against the slots, in tiles of WC_TILE x WC_TILE pairs that
//            the blocks take in turn (common.cuh babble_count_ge_tile: a
//            4 x 4 register tile a thread, the coordinates through a
//            cp.async ring); each tile's strongly-seen witnesses per row,
//            summed by half-warp shuffles, are added into the round's sums
//            (three buffers in rotation) once a tile; then one grid
//            barrier, after which every block takes, for the chains of its
//            tiles, the same decisions from the sums and picks the next
//            round's probes (the block of a chain tile's first witness tile
//            keeps lo and hi for the next round, two buffers in rotation).
//            A settled chain (lo >= hi, hi <= l - 1: every later mid is at
//            or above hi, so hi and m0 cannot change) probes nothing, and a
//            tile whose chains have all settled is not counted: its sums
//            stay 0, which moves only lo;
//   m0:      after the last round every block decides its share of the
//            chains and writes m0; one more barrier, then the advance.
// A table byte crosses L2 once per chain tile a round, not once per chain
// and probe; the shared memory is the count tile's at every width.
//
// Every form skips the search of a step whose frontier holds fewer than
// super_majority countable rows. The predicate counts strongly-seen
// countable rows, so it is false for every probe of such a step: every
// search ends at hi = l and m0 = l, which is what the skip writes. The
// advance still runs: its closure terms are the sentinel, and the seed row
// and the clamp apply as they do in the reference (a seeded step may move
// X, and under seeds a later step may count more rows, through first_nw).
// The tree form counts the rows with a ballot; the grid forms count them
// in the advance, an atomic into one of three counters in rotation, read
// after the step's first grid barrier, so every block skips alike, and a
// skipped step has no second barrier (nothing is searched before its
// advance). The cluster form issues no bulk copy in a skipped step and
// waits on the parity of its copies, not of its steps.
//
// The frontier, m0, the chain lengths and the device table live in a
// device scratch the wrapper allocates, read and written through L2
// (__ldcg / __stcg); the grid barrier's fences order them, and a proxy
// fence orders the table's generic writes before the bulk copies read it.
//
// Launches per call (one chunk): one (walk_chunk_tree: two, the prep
// launch and the walk).
//
// walk_chunk_cluster's launch: cudaLaunchKernelEx with the cluster
// dimension attribute and the cooperative attribute, which the runtime
// takes together on the H100 (checked on the card); the grid is at most
// cudaOccupancyMaxActiveClusters clusters, so that every block is resident.
// A refused launch returns its error (the wrapper raises).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// largest dynamic shared memory one block may use on an H100
#define WC_MAX_SMEM 232448
// walk_chunk_tree up to this many validators
#define WC_BLOCK_MAX 32
// the largest tree depth (walk_chunk_tree: a round's verdicts fit a 64-bit
// mask)
#define WC_TREE_DEPTH_MAX 6
// walk_chunk_cluster: the most threads a block (tpu/_ext.py walk_chunk_plan
// takes 256, and 512 in clusters of 4 or 8), the widest (portable)
// cluster, and the probe rows a thread counts at once
#define WC_GRID_THREADS_WIDE 512
#define WC_CLUSTER_MAX 8
#define WC_SLOT_CHUNK 4
// the plan's forms (tpu/_ext.py WC_FORMS)
#define WC_FORM_TREE 0
#define WC_FORM_CLUSTER 1
#define WC_FORM_L2 2

// walk_chunk_tiles: WC_TILE probe rows x WC_TILE table slots a tile, a
// WC_TILE_TM x WC_TILE_TN register tile a thread (WC_TILE_THREADS
// threads), the coordinate ring WC_TILE_STAGES deep (tpu/_ext.py
// WC_TILE_SMEM is its shared memory)
#define WC_TILE 64
#define WC_TILE_TM 4
#define WC_TILE_TN 4
#define WC_TILE_THREADS ((WC_TILE / WC_TILE_TM) * (WC_TILE / WC_TILE_TN))
#define WC_TILE_STAGES 3
// the grid forms' step counters: the grid barrier's count, then three
// counters of countable frontier rows in rotation (step k's in k % 3), at
// the end of the scratch, zeroed before the launch
#define WC_COUNTERS 4

// The device table's word of coordinate p, witness w, in slices of cw
// columns (walk_chunk_cluster).
__device__ __forceinline__ long long wc_tab_at(int p, int w, int n, int cw) {
    const int r = w / cw;
    return ((long long)r * n + p) * cw + (w - r * cw);
}

// Whether frontier row w at index x is countable in round r_cur.
__device__ __forceinline__ bool wc_countable(int w, int x, int r_cur,
                                             const int32_t* __restrict__ first_nw, int l,
                                             int use_seeds) {
    return x < l && !(use_seeds && x == 0 && r_cur == first_nw[w]);
}

// Frontier row w at index x, round r_cur, into the next step's table; one
// whole warp. TILED (walk_chunk_tiles): a countable row takes the slot its
// count gives it (okc, the step's counter) and its fd row is written there,
// slots cw (ld4) words apart; else (walk_chunk_cluster) column w of the table in
// slices of cw and wok[w], the countable rows counted into okc, the
// table's generic writes fenced against the next step's bulk copies (the
// async proxy).
template <bool TILED>
__device__ __forceinline__ void wc_frontier_row(
    int w, int x, int r_cur, const int32_t* __restrict__ rows_by,
    const int32_t* __restrict__ fd, const int32_t* __restrict__ first_nw, int32_t* tab,
    int32_t* wok, unsigned int* okc, int n, int cw, int l, int e_fd, int use_seeds) {
    const int lane = threadIdx.x & 31;
    const bool ok = wc_countable(w, x, r_cur, first_nw, l, use_seeds);
    const int row = ok ? babble_clamp(
        rows_by[(long long)w * l + babble_clamp(x, 0, l - 1)], 0, e_fd - 1) : 0;
    const int32_t* src = fd + (long long)row * n;
    if (TILED) {
        if (!ok) return;  // warp-uniform
        int slot = 0;
        if (lane == 0) slot = (int)atomicAdd(okc, 1u);
        slot = __shfl_sync(BABBLE_FULL_MASK, slot, 0);
        int32_t* dst = tab + (long long)slot * cw;
#pragma unroll 8
        for (int p = lane; p < n; p += 32) __stcg(dst + p, src[p]);
        return;
    }
#pragma unroll 8
    for (int p = lane; p < n; p += 32) {
        __stcg(tab + wc_tab_at(p, w, n, cw), ok ? src[p] : BABBLE_MAX_INT32);
    }
    if (lane == 0) {
        __stcg(wok + w, (int32_t)ok);
        if (ok) atomicAdd(okc, 1u);
    }
    asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The prologue of both grid forms: (cluster) the table's padding columns
// (n .. n_cols - 1) MAX and their flags 0; each chain's length, X(0) and
// the first step's frontier row.
template <bool TILED>
__device__ __forceinline__ void wc_prologue(
    const int32_t* __restrict__ rows_by, const int32_t* __restrict__ fd,
    const int32_t* __restrict__ x0, const int32_t* __restrict__ r_abs,
    const int32_t* __restrict__ first_nw, int32_t* g_tab, int32_t* g_wok, unsigned int* okc,
    int32_t* xc, int32_t* clen, int n, int cw, int n_cols, int l, int e_fd, int use_seeds) {
    const int lane = threadIdx.x & 31;
    const int pad = TILED ? 0 : n_cols - n;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < (long long)n * pad;
         k += (long long)gridDim.x * blockDim.x) {
        const int p = (int)(k / pad), w = n + (int)(k % pad);
        __stcg(g_tab + wc_tab_at(p, w, n, cw), BABBLE_MAX_INT32);
        if (p == 0) __stcg(g_wok + w, 0);
    }
    const int n_warps = blockDim.x >> 5;
    const int all_warps = gridDim.x * n_warps;
    for (int c = blockIdx.x * n_warps + (threadIdx.x >> 5); c < n; c += all_warps) {
        int cnt = 0;
        for (int i = lane; i < l; i += 32) cnt += rows_by[(long long)c * l + i] >= 0;
        cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
        const int x = x0[c];
        if (lane == 0) {
            __stcg(clen + c, cnt);
            __stcg(xc + c, x);
        }
        wc_frontier_row<TILED>(c, x, r_abs[0], rows_by, fd, first_nw, g_tab, g_wok, okc, n, cw,
                               l, e_fd, use_seeds);
    }
}

// The advance of both grid forms: one warp per chain over the whole grid
// takes the cross-chain closure (none where the step skipped its search:
// every m0 is l), the seed row and the clamp, writes X(r+1), then the next
// step's frontier row, counted into okc; chain c's warp alone reads and
// writes xc[c].
template <bool TILED>
__device__ __forceinline__ void wc_advance(
    int k, bool skip, const int32_t* __restrict__ inv, const int32_t* __restrict__ rows_by,
    const int32_t* __restrict__ fd, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ r_abs, const int32_t* __restrict__ first_nw, int32_t* x_last,
    int32_t* xs, int32_t* g_tab, int32_t* g_wok, unsigned int* okc, int32_t* xc,
    const int32_t* m0, int n, int cw, int l, int e_fd, int length, int use_seeds) {
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const int all_warps = gridDim.x * n_warps;
    for (int c = blockIdx.x * n_warps + (threadIdx.x >> 5); c < n; c += all_warps) {
        int xn = l;
        if (!skip) {
            int r = l;
            const int32_t* inv_c = inv + (long long)c * n * l;
#pragma unroll 8
            for (int x = lane; x < n; x += 32) {
                const int mx = __ldcg(m0 + x);
                if (mx < l) r = min(r, inv_c[(long long)x * l + babble_clamp(mx, 0, l - 1)]);
            }
            r = __reduce_min_sync(BABBLE_FULL_MASK, r);
            xn = min(__ldcg(m0 + c), r);
        }
        if (use_seeds) xn = min(xn, seeds[(long long)k * n + c]);
        xn = min(max(xn, __ldcg(xc + c)), l);
        __syncwarp();
        if (lane == 0) {
            xs[(long long)k * n + c] = xn;
            __stcg(xc + c, xn);
            if (k == length - 1) x_last[c] = xn;
        }
        if (k + 1 < length) {
            wc_frontier_row<TILED>(c, xn, r_abs[k + 1], rows_by, fd, first_nw, g_tab, g_wok, okc,
                                   n, cw, l, e_fd, use_seeds);
        }
    }
}

// One round's d decisions of a chain's search from (lo, hi), node j's
// verdict sum at sums[j - 1] (heap order): the reference's iteration, the
// predicate false on an empty chain.
__device__ __forceinline__ void wc_decide(int& lo, int& hi, const int32_t* sums, int d, int len,
                                          int super_majority, int l) {
    int j = 1;
    for (int st = 0; st < d; ++st) {
        const int mid = min((lo + hi) / 2, l - 1);
        if (len > 0 && __ldcg(sums + j - 1) >= super_majority) {
            hi = min(mid, hi);
            j = 2 * j;
        } else {
            lo = mid + 1;
            j = 2 * j + 1;
        }
    }
}

// The probe of node j (heap order, j >= 1) of a search tree from (lo, hi):
// the index the iteration probes once it has taken node j's path.
__device__ __forceinline__ int wc_node_probe(int j, int lo, int hi, int len, int l) {
    int a = lo, b = hi;
    for (int bit = 30 - __clz(j); bit >= 0; --bit) {
        const int mid = min((a + b) / 2, l - 1);
        if ((j >> bit) & 1) a = mid + 1;
        else b = min(mid, b);
    }
    return min(min((a + b) / 2, l - 1), max(len - 1, 0));
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
// loads (the first beside the frontier rows') and two block barriers; a
// step with fewer than super_majority countable rows (a ballot) stages and
// searches nothing.
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
        // the step's countable frontier rows, counted alike in every warp:
        // below super_majority the search is skipped (m0 = l, no leaf)
        const bool skip = __popc(__ballot_sync(
            BABBLE_FULL_MASK, lane < n && wc_countable(lane, xc[min(lane, n - 1)], r_cur, s_fnw, l,
                                                       use_seeds))) < super_majority;
        // the frontier rows: row w in registers (up to 8 validators each
        // lane loads its own; past that the block stages each row once,
        // read after round 0's barrier)
        bool ok = false;
        int4 f[NV];
        if (!skip && STAGE_FD) {
            for (int it = tid; it < n * NV; it += blockDim.x) {
                const int w2 = it / NV, v = it - w2 * NV;
                const int x = xc[w2];
                const bool ok2 = x < l && !(use_seeds && x == 0 && r_cur == s_fnw[w2]);
                s_fd[w2 * (NV + 1) + v] =
                    ok2 ? fd4[((long long)w2 * l + babble_clamp(x, 0, l - 1)) * NV + v] : none;
                if (v == 0) s_ok[w2] = ok2;
            }
        } else if (!skip) {
            const int x = w < n ? xc[w] : l;
            ok = w < n && x < l && !(use_seeds && x == 0 && r_cur == s_fnw[w]);
            const int4* src = fd4 + ((long long)w * l + babble_clamp(x, 0, l - 1)) * NV;
#pragma unroll
            for (int j = 0; j < NV; ++j) f[j] = ok ? src[j] : none;
        }
        // chain c's search, `depth` iterations a round
        int lo = babble_clamp(xc[c], 0, l), hi = l;
        int leaf = -1;  // the last round's leaf, once taken
        for (int done = skip ? steps : 0; done < steps;) {  // block-uniform
            const int d = min(depth, steps - done);
            const int nodes_r = (1 << d) - 1;
            const bool final_round = done + d == steps;
            for (int it = lane; it < nodes_r * nv; it += 32) {
                const int node = it / nv, v = it - node * nv;
                s_la[it] = la4[(long long)wc_node_probe(node + 1, lo, hi, len, l) * nv + v];
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

// walk_chunk_cluster (the header above): clusters of k blocks, `chains`
// chains a cluster at a time, trees of `depth`.
__global__ void __launch_bounds__(WC_GRID_THREADS_WIDE) walk_chunk_cluster(
    const int32_t* __restrict__ inv, const int32_t* __restrict__ rows_by,
    const int32_t* __restrict__ fd, const int32_t* __restrict__ la,
    const int32_t* __restrict__ x0, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ r_abs, const int32_t* __restrict__ first_nw, int32_t* x_last,
    int32_t* xs, int32_t* scratch, int n, int l, int e_fd, int e_la, int super_majority,
    int length, int steps, int use_seeds, int depth, int cw, int chains, int slots) {
    cg::cluster_group cluster = cg::this_cluster();
    const int k_cl = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int cid = blockIdx.x / k_cl, n_cl = gridDim.x / k_cl;
    const int ld4 = (n + 3) & ~3;
    const int nq = cw >> 2;
    const int nodes = (1 << depth) - 1;
    const int lane = threadIdx.x & 31;

    // device scratch: the table (k slices of (n, cw)), the countable flags
    // (k * cw), the frontier, m0, the chain lengths, the barrier's count and
    // the step counters
    int32_t* g_tab = scratch;
    int32_t* g_wok = g_tab + (long long)n * cw * k_cl;
    int32_t* xc = g_wok + cw * k_cl;
    int32_t* m0 = xc + n;
    int32_t* clen = m0 + n;
    unsigned int* bar = reinterpret_cast<unsigned int*>(clen + n);
    unsigned int* okc = bar + 1;
    unsigned int bar_target = 0;
    // shared memory (tpu/_ext.py _wc_cluster_smem sizes it)
    extern __shared__ int4 wcc_smem4[];
    uint64_t* tbar = reinterpret_cast<uint64_t*>(wcc_smem4);
    int32_t* tab = reinterpret_cast<int32_t*>(wcc_smem4 + 1);
    int32_t* wok = tab + (long long)n * cw;
    int32_t* rows_s = wok + cw;
    int32_t* la_s = rows_s + ((long long)chains * l + 3) / 4 * 4;
    int32_t* cnt = la_s + (long long)slots * ld4;
    int32_t* part = cnt + slots * cw;
    int32_t* s_lo = part + 2 * slots;
    int32_t* s_hi = s_lo + chains;
    int32_t* s_len = s_hi + chains;

    if (threadIdx.x == 0) {
        babble_mbar_init(tbar, 1);
        babble_mbar_init_fence();
    }
    for (int i = threadIdx.x; i < 2 * slots; i += blockDim.x) part[i] = 0;
    for (int i = threadIdx.x; i < slots * cw; i += blockDim.x) cnt[i] = 0;
    wc_prologue<false>(rows_by, fd, x0, r_abs, first_nw, g_tab, g_wok, okc, xc, clen, n, cw,
                       cw * k_cl, l, e_fd, use_seeds);
    // every block of the cluster runs (and its mbarrier is initialised)
    // before any block reads another's shared memory
    cluster.sync();

    // a thread's count item: (4 probe rows, a quad of columns) x a range of
    // coordinates, `ranges` ranges of `span` coordinates
    const int units = (slots / WC_SLOT_CHUNK) * nq;
    int ranges = blockDim.x / units;
    ranges = max(1, min(ranges, n / 8));
    const int span = (n + ranges - 1) / ranges;
    const int4* tab4 = reinterpret_cast<const int4*>(tab);
    const bool la16 = babble_rows_aligned16(la, n);
    const int nla = la16 ? n / 4 : n;  // copies a probed row
    int rnd = 0;  // block-uniform: the verdict sums' buffer is rnd & 1
    int copies = 0;  // block-uniform: the table copies waited for

    for (int k = 0; k < length; ++k) {
        babble_grid_sync(bar, bar_target);
        // the step's countable rows; the counter of step k + 2 starts at 0
        // (step k - 1's, which every block read before this barrier)
        const bool skip = (int)__ldcg(okc + k % 3) < super_majority;
        if (blockIdx.x == 0 && threadIdx.x == 0) __stcg(okc + (k + 2) % 3, 0u);
        if (skip) {
            wc_advance<false>(k, true, inv, rows_by, fd, seeds, r_abs, first_nw, x_last, xs,
                              g_tab, g_wok, okc + (k + 1) % 3, xc, m0, n, cw, l, e_fd, length,
                              use_seeds);
            continue;
        }
        // this step's table slice (one bulk copy) and countable flags
        if (threadIdx.x == 0) {
            asm volatile("fence.proxy.async;\n" ::: "memory");
            const unsigned bytes = (unsigned)n * (unsigned)cw * 4u;
            babble_mbar_expect_tx(tbar, bytes);
            babble_bulk_load(tab, g_tab + (long long)rank * n * cw, bytes, tbar);
        }
        for (int w = threadIdx.x; w < cw; w += blockDim.x) wok[w] = __ldcg(g_wok + rank * cw + w);
        bool waited = false;
        for (int c0 = cid * chains; c0 < n; c0 += n_cl * chains) {
            // the group's rows_by rows, frontier and lengths
            for (int i = threadIdx.x; i < chains * l; i += blockDim.x) {
                const int c = c0 + i / l;
                rows_s[i] = c < n ? rows_by[(long long)c * l + i % l] : -1;
            }
            for (int i = threadIdx.x; i < chains; i += blockDim.x) {
                const int c = c0 + i;
                s_lo[i] = c < n ? babble_clamp(__ldcg(xc + c), 0, l) : 0;
                s_hi[i] = l;
                s_len[i] = c < n ? __ldcg(clen + c) : 0;
            }
            __syncthreads();
            if (!waited) {
                babble_mbar_wait(tbar, copies & 1);
                waited = true;
            }
            for (int done = 0; done < steps; ++rnd) {  // block-uniform
                const int d = min(depth, steps - done);
                const int nodes_r = (1 << d) - 1;
                int32_t* my_part = part + (rnd & 1) * slots;
                // the probed rows, asynchronously (16 bytes a copy where the
                // rows allow it), so that a thread's copies overlap: slot
                // i * nodes + j - 1 holds node j of chain i's tree (heap
                // order), MIN where there is none
                for (int t = threadIdx.x; t < slots * nla; t += blockDim.x) {
                    const int sl = t / nla, p = (t - sl * nla) * (la16 ? 4 : 1);
                    const int i = sl / nodes, node = sl - i * nodes;
                    int32_t* dst = la_s + sl * ld4 + p;
                    if (i >= chains || node >= nodes_r || c0 + i >= n) {
                        for (int j = 0; j < (la16 ? 4 : 1); ++j) dst[j] = BABBLE_MIN_INT32;
                        continue;
                    }
                    const int probe = wc_node_probe(node + 1, s_lo[i], s_hi[i], s_len[i], l);
                    const int32_t* src =
                        la + (long long)babble_clamp(rows_s[i * l + probe], 0, e_la - 1) * n + p;
                    if (la16) babble_cp_async16(dst, src);
                    else babble_cp_async4(dst, src);
                }
                babble_cp_async_commit();
                babble_cp_async_wait<0>();
                __syncthreads();
                // the counts against this block's columns (zeroed after the
                // previous round's verdicts)
                for (int it = threadIdx.x; it < units * ranges; it += blockDim.x) {
                    const int rg = it / units, u = it - rg * units;
                    const int q = u % nq, sc = u / nq;
                    const int p1 = min(n, (rg + 1) * span);
                    const int32_t* a = la_s + (long long)sc * WC_SLOT_CHUNK * ld4;
                    int c[WC_SLOT_CHUNK][4];
#pragma unroll
                    for (int j = 0; j < WC_SLOT_CHUNK; ++j) {
                        c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0;
                    }
                    for (int p = rg * span; p < p1; ++p) {
                        const int4 t4 = tab4[p * nq + q];
#pragma unroll
                        for (int j = 0; j < WC_SLOT_CHUNK; ++j) {
                            const int v = a[j * ld4 + p];
                            c[j][0] += v >= t4.x;
                            c[j][1] += v >= t4.y;
                            c[j][2] += v >= t4.z;
                            c[j][3] += v >= t4.w;
                        }
                    }
#pragma unroll
                    for (int j = 0; j < WC_SLOT_CHUNK; ++j) {
                        int32_t* dst = cnt + (sc * WC_SLOT_CHUNK + j) * cw + 4 * q;
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            if (c[j][e]) atomicAdd(dst + e, c[j][e]);
                        }
                    }
                }
                __syncthreads();
                // each probe's strongly-seen witnesses among this block's
                // columns, summed a warp at a time
                for (int t = threadIdx.x; t < slots * cw; t += blockDim.x) {
                    const int sl = t / cw;
                    const bool v = cnt[t] >= super_majority && wok[t - sl * cw] != 0;
                    const unsigned act = __activemask();
                    const unsigned peers = __match_any_sync(act, sl);
                    const unsigned hits = __ballot_sync(act, v) & peers;
                    if (lane == __ffs(peers) - 1 && hits) atomicAdd(my_part + sl, __popc(hits));
                }
                // every block's sums, after the cluster's barrier (one block:
                // the block's)
                if (k_cl > 1) cluster.sync();
                else __syncthreads();
                // the round's decisions, the same in every block, each node's
                // total the sum of the cluster's partial sums
                for (int i = threadIdx.x; i < chains; i += blockDim.x) {
                    int lo = s_lo[i], hi = s_hi[i], j = 1;
                    const bool live = s_len[i] > 0;
                    for (int st = 0; st < d; ++st) {
                        const int mid = min((lo + hi) / 2, l - 1);
                        int32_t* at = my_part + i * nodes + j - 1;
                        int total = *at;
                        if (k_cl > 1) {
                            total = 0;
                            for (int r = 0; r < k_cl; ++r) total += *cluster.map_shared_rank(at, r);
                        }
                        if (live && total >= super_majority) {
                            hi = min(mid, hi);
                            j = 2 * j;
                        } else {
                            lo = mid + 1;
                            j = 2 * j + 1;
                        }
                    }
                    s_lo[i] = lo;
                    s_hi[i] = hi;
                }
                // the next round's buffers: the other sums (every block read
                // them before this round's barrier) and the counts
                for (int t = threadIdx.x; t < slots; t += blockDim.x) {
                    part[((rnd + 1) & 1) * slots + t] = 0;
                }
                for (int t = threadIdx.x; t < slots * cw; t += blockDim.x) cnt[t] = 0;
                __syncthreads();
                done += d;
            }
            if (rank == 0) {
                for (int i = threadIdx.x; i < chains && c0 + i < n; i += blockDim.x) {
                    __stcg(m0 + c0 + i, s_hi[i] < s_len[i] ? s_hi[i] : l);
                }
            }
            __syncthreads();  // the group's arrays are rewritten by the next
        }
        if (!waited) babble_mbar_wait(tbar, copies & 1);
        ++copies;
        babble_grid_sync(bar, bar_target);
        wc_advance<false>(k, false, inv, rows_by, fd, seeds, r_abs, first_nw, x_last, xs, g_tab,
                          g_wok, okc + (k + 1) % 3, xc, m0, n, cw, l, e_fd, length, use_seeds);
    }
    // no block leaves while another of its cluster may read its shared memory
    cluster.sync();
}

// walk_chunk_tiles (the header above): the rounds of a step's search
// counted for all chains at once, tiles of WC_TILE probe rows x WC_TILE
// table slots over a persistent cooperative grid.
__global__ void __launch_bounds__(WC_TILE_THREADS) walk_chunk_tiles(
    const int32_t* __restrict__ inv, const int32_t* __restrict__ rows_by,
    const int32_t* __restrict__ fd, const int32_t* __restrict__ la,
    const int32_t* __restrict__ x0, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ r_abs, const int32_t* __restrict__ first_nw, int32_t* x_last,
    int32_t* xs, int32_t* scratch, int n, int l, int e_fd, int e_la, int super_majority,
    int length, int steps, int use_seeds, int depth) {
    constexpr int TX = WC_TILE / WC_TILE_TN, TY = WC_TILE / WC_TILE_TM;
    extern __shared__ int4 wct_smem4[];
    int32_t* ring = reinterpret_cast<int32_t*>(wct_smem4);
    __shared__ const int32_t* a_rows[WC_TILE];  // the tile's probe rows (la rows)
    __shared__ const int32_t* b_rows[WC_TILE];  // the tile's table slots
    const int ld4 = (n + 3) & ~3;
    const int nodes_max = (1 << depth) - 1;
    const long long sums = (long long)n * nodes_max;
    const int tid = threadIdx.x;
    const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
    const long long gthreads = (long long)gridDim.x * blockDim.x;

    // device scratch: the table (n slots of ld4 words), lo and hi of every
    // chain (two rounds in rotation), the rounds' verdict sums (three in
    // rotation, (chain, node) a row), the frontier, m0, the chain lengths,
    // the barrier's count and the step counters
    int32_t* tab = scratch;
    int32_t* s_lo = tab + (long long)n * ld4;  // [2][n]
    int32_t* s_hi = s_lo + 2LL * n;            // [2][n]
    int32_t* seen = s_hi + 2LL * n;            // [3][n * nodes_max]
    int32_t* xc = seen + 3 * sums;
    int32_t* m0 = xc + n;
    int32_t* clen = m0 + n;
    unsigned int* bar = reinterpret_cast<unsigned int*>(clen + n);
    unsigned int* okc = bar + 1;
    unsigned int bar_target = 0;

    for (long long i = gtid; i < 3 * sums; i += gthreads) __stcg(seen + i, 0);
    wc_prologue<true>(rows_by, fd, x0, r_abs, first_nw, tab, nullptr, okc, xc, clen, n, ld4,
                      ld4, l, e_fd, use_seeds);
    // 16-byte copies where every la row and table slot starts on 16 bytes
    const bool aligned16 = babble_rows_aligned16(la, n) && babble_rows_aligned16(tab, ld4);
    int rnd = 0;  // grid-uniform: round rnd adds into seen buffer rnd % 3

    for (int k = 0; k < length; ++k) {
        babble_grid_sync(bar, bar_target);
        // the step's countable rows (its table's slots); the counter of
        // step k + 2 starts at 0 (step k - 1's, read before this barrier)
        const int n_ok = (int)__ldcg(okc + k % 3);
        if (blockIdx.x == 0 && tid == 0) __stcg(okc + (k + 2) % 3, 0u);
        const bool skip = n_ok < super_majority || steps < 1;  // m0 = l either way
        if (!skip) {
            // at least one witness tile, so that every chain tile is taken
            const int n_wt = max((n_ok + WC_TILE - 1) / WC_TILE, 1);
            int t = 0, d = 0, nodes = 0;
            for (int done = 0; done < steps; done += d, ++t, ++rnd) {
                const int d_prev = d;
                d = min(depth, steps - done);
                nodes = (1 << d) - 1;
                const int rows = n * nodes;
                const int n_mt = (rows + WC_TILE - 1) / WC_TILE;
                int32_t* seen_t = seen + (rnd % 3) * sums;
                const int32_t* seen_p = seen + ((rnd + 2) % 3) * sums;
                int32_t* lo_t = s_lo + (t & 1) * n;
                int32_t* hi_t = s_hi + (t & 1) * n;
                const int32_t* lo_p = s_lo + ((t + 1) & 1) * n;
                const int32_t* hi_p = s_hi + ((t + 1) & 1) * n;
                // the next round's sums start at 0 (round rnd - 2's, read
                // before this round's barrier)
                int32_t* seen_n = seen + ((rnd + 1) % 3) * sums;
                for (long long i = gtid; i < sums; i += gthreads) __stcg(seen_n + i, 0);
                for (int item = blockIdx.x; item < n_mt * n_wt; item += gridDim.x) {
                    const int mt = item / n_wt, wt = item - mt * n_wt;
                    const int32_t* a = nullptr;
                    if (tid < WC_TILE) {
                        // probe row r = (chain c, node): the chain's
                        // interval after the previous round's decisions
                        // (the same in every block), then the node's
                        // probe; none for an empty or settled chain
                        const int r = mt * WC_TILE + tid;
                        if (r < rows) {
                            const int c = r / nodes, node = r - c * nodes;
                            const int len = __ldcg(clen + c);
                            int lo, hi;
                            if (t == 0) {
                                lo = babble_clamp(__ldcg(xc + c), 0, l);
                                hi = l;
                            } else {
                                lo = __ldcg(lo_p + c);
                                hi = __ldcg(hi_p + c);
                                wc_decide(lo, hi, seen_p + (long long)c * nodes_max, d_prev, len,
                                          super_majority, l);
                            }
                            if (wt == 0 && node == 0) {
                                __stcg(lo_t + c, lo);
                                __stcg(hi_t + c, hi);
                            }
                            if (len > 0 && !(lo >= hi && hi <= l - 1)) {
                                const int probe = wc_node_probe(node + 1, lo, hi, len, l);
                                a = la + (long long)babble_clamp(
                                    rows_by[(long long)c * l + probe], 0, e_la - 1) * n;
                            }
                        }
                        a_rows[tid] = a;
                        const int w = wt * WC_TILE + tid;
                        b_rows[tid] = w < n_ok ? tab + (long long)w * ld4 : nullptr;
                    }
                    // a tile whose chains have all settled counts nothing
                    if (!__syncthreads_or(a != nullptr)) continue;  // block-uniform
                    int cnt[WC_TILE_TM][WC_TILE_TN];
                    babble_count_ge_tile<WC_TILE, WC_TILE, WC_TILE_TM, WC_TILE_TN,
                                         WC_TILE_STAGES>(ring, n, a_rows, b_rows, aligned16,
                                                         cnt);
                    // each row's strongly-seen slots of the tile: a thread's
                    // TN slots, then the TX threads of its row (a half warp)
                    const int tx = tid % TX, ty = tid / TX;
#pragma unroll
                    for (int i = 0; i < WC_TILE_TM; ++i) {
                        int v = 0;
#pragma unroll
                        for (int q = 0; q < WC_TILE_TN; ++q) {
                            v += wt * WC_TILE + tx + q * TX < n_ok &&
                                 cnt[i][q] >= super_majority;
                        }
#pragma unroll
                        for (int off = TX / 2; off > 0; off >>= 1) {
                            v += __shfl_xor_sync(BABBLE_FULL_MASK, v, off);
                        }
                        const int r = mt * WC_TILE + ty + i * TY;
                        if (tx == 0 && v > 0 && r < rows) atomicAdd(seen_t + r, v);
                    }
                    __syncthreads();  // a_rows and b_rows are rewritten next
                }
                babble_grid_sync(bar, bar_target);
            }
            // the last round's decisions: m0 of every chain
            const int32_t* lo_p = s_lo + ((t + 1) & 1) * n;
            const int32_t* hi_p = s_hi + ((t + 1) & 1) * n;
            const int32_t* seen_p = seen + ((rnd + 2) % 3) * sums;
            for (long long c = gtid; c < n; c += gthreads) {
                const int len = __ldcg(clen + c);
                int lo = __ldcg(lo_p + c), hi = __ldcg(hi_p + c);
                wc_decide(lo, hi, seen_p + c * nodes, d, len, super_majority, l);
                __stcg(m0 + c, hi < len ? hi : l);
            }
            babble_grid_sync(bar, bar_target);
        }
        wc_advance<true>(k, skip, inv, rows_by, fd, seeds, r_abs, first_nw, x_last, xs, tab,
                         nullptr, okc + (k + 1) % 3, xc, m0, n, ld4, l, e_fd, length, use_seeds);
    }
}

// walk_chunk_tree<NP>'s launch: the chain-order tables (rows of NP words)
// and the chain lengths, then the walk.
template <int NP>
static int wc_tree_launch(const int32_t* inv, const int32_t* rows_by, const int32_t* fd,
                          const int32_t* la, const int32_t* x0, const int32_t* seeds,
                          const int32_t* r_abs, const int32_t* first_nw, int32_t* x_last,
                          int32_t* xs, int32_t* scratch, int n, int l, int e_fd, int e_la,
                          int super_majority, int length, int steps, int use_seeds, int depth,
                          size_t smem, cudaStream_t s) {
    int32_t* la_by = scratch;
    int32_t* fd_by = scratch + (long long)n * l * NP;
    int32_t* len = fd_by + (long long)n * l * NP;
    BABBLE_CHECK(cudaMemsetAsync(len, 0, (size_t)n * sizeof(int32_t), s));
    wc_tables<<<babble_stride_blocks((long long)n * l * NP, 256), 256, 0, s>>>(
        rows_by, la, fd, la_by, fd_by, len, n, l, e_la, e_fd, NP);
    BABBLE_CHECK_LAUNCH();
    BABBLE_CHECK(babble_allow_smem(walk_chunk_tree<NP>, smem));
    walk_chunk_tree<NP><<<1, 32 * n, smem, s>>>(
        inv, len, fd_by, la_by, x0, seeds, r_abs, first_nw, x_last, xs, n, l,
        super_majority, length, steps, use_seeds, depth);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// The launch in the form of tpu/_ext.py walk_chunk_plan, whose fields the
// wrapper hands over as they are: `form` (WC_FORM_*), k blocks a cluster,
// cw witness columns a block (walk_chunk_tiles: the table's row of ld4
// words), `chains` chains a block searches at once (walk_chunk_tiles: the
// probe rows of a tile), `slots` probe rows a block stages
// (walk_chunk_tiles: the table slots of a tile), threads a block and
// dynamic shared memory bytes a block.
extern "C" int babble_walk_chunk(
    const int32_t* inv, const int32_t* rows_by, const int32_t* fd,
    const int32_t* la, const int32_t* x0, const int32_t* seeds,
    const int32_t* r_abs, const int32_t* first_nw, int32_t* x_last,
    int32_t* xs, int32_t* scratch, int n, int l, int e_fd, int e_la,
    int super_majority, int length, int steps, int use_seeds, int depth, int form, int k,
    int cw, int chains, int slots, int threads, int smem_bytes, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (depth < 1 || depth > WC_TREE_DEPTH_MAX || smem_bytes < 0 || smem_bytes > WC_MAX_SMEM) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = (size_t)smem_bytes;
    if (form == WC_FORM_TREE) {
        if (n > WC_BLOCK_MAX) return (int)cudaErrorInvalidValue;
        if (n <= 4) {
            return wc_tree_launch<4>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last,
                                     xs, scratch, n, l, e_fd, e_la, super_majority, length,
                                     steps, use_seeds, depth, smem, s);
        }
        if (n <= 8) {
            return wc_tree_launch<8>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last,
                                     xs, scratch, n, l, e_fd, e_la, super_majority, length,
                                     steps, use_seeds, depth, smem, s);
        }
        if (n <= 16) {
            return wc_tree_launch<16>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw,
                                      x_last, xs, scratch, n, l, e_fd, e_la, super_majority,
                                      length, steps, use_seeds, depth, smem, s);
        }
        return wc_tree_launch<32>(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last,
                                  xs, scratch, n, l, e_fd, e_la, super_majority, length,
                                  steps, use_seeds, depth, smem, s);
    }
    const int ld4 = (n + 3) & ~3;
    if (form == WC_FORM_L2) {
        if (k != 1 || cw != ld4 || chains != WC_TILE || slots != WC_TILE ||
            threads != WC_TILE_THREADS ||
            smem_bytes != babble_count_tile_words<WC_TILE, WC_TILE, WC_TILE_STAGES>() * 4) {
            return (int)cudaErrorInvalidValue;
        }
        // scratch (the wrapper sizes it from the same plan): the table, lo
        // and hi (2 x 2n), the verdict sums (3 x n * nodes), the frontier,
        // m0, the chain lengths, then the barrier's count and the step
        // counters, 0 at launch
        const long long nodes = (1LL << depth) - 1;
        unsigned int* bar = reinterpret_cast<unsigned int*>(
            scratch + (long long)n * ld4 + 4LL * n + 3LL * n * nodes + 3LL * n);
        BABBLE_CHECK(cudaMemsetAsync(bar, 0, WC_COUNTERS * sizeof(unsigned int), s));
        // as many blocks as can be resident at once (the grid barrier needs
        // every block running), at most the widest round's tiles or a warp
        // a chain for the advance, whichever is more
        BABBLE_CHECK(babble_allow_smem(walk_chunk_tiles, smem));
        const long long tiles = ((n * nodes + WC_TILE - 1) / WC_TILE) *
                                (((long long)n + WC_TILE - 1) / WC_TILE);
        const long long warps = ((long long)n * 32 + threads - 1) / threads;
        int grid = 0;
        BABBLE_CHECK(babble_coop_blocks(walk_chunk_tiles, threads, smem, device,
                                        tiles > warps ? tiles : warps, &grid));
        void* args[] = {
            (void*)&inv, (void*)&rows_by, (void*)&fd, (void*)&la, (void*)&x0,
            (void*)&seeds, (void*)&r_abs, (void*)&first_nw, (void*)&x_last,
            (void*)&xs, (void*)&scratch, (void*)&n, (void*)&l, (void*)&e_fd,
            (void*)&e_la, (void*)&super_majority, (void*)&length, (void*)&steps,
            (void*)&use_seeds, (void*)&depth,
        };
        BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)walk_chunk_tiles, dim3(grid),
                                                 dim3(threads), args, smem, s));
        BABBLE_CHECK_LAUNCH();
        return 0;
    }
    if (form != WC_FORM_CLUSTER || k < 1 || k > WC_CLUSTER_MAX || (k & (k - 1)) != 0 || cw < 4 ||
        cw % 4 != 0 || chains < 1 || slots < 0 || threads < 32 ||
        threads > WC_GRID_THREADS_WIDE || threads % 32 != 0) {
        return (int)cudaErrorInvalidValue;
    }
    // scratch (the wrapper sizes it from the same plan): the device table
    // and flags (k * cw columns), the frontier, m0, the chain lengths, then
    // the grid barrier's count and the step counters, 0 at launch
    const long long cols = (long long)k * cw;
    unsigned int* bar = reinterpret_cast<unsigned int*>(scratch + (long long)n * cols + cols +
                                                        3LL * n);
    BABBLE_CHECK(cudaMemsetAsync(bar, 0, WC_COUNTERS * sizeof(unsigned int), s));
    // walk_chunk_cluster: clusters of k blocks, at most one a group of
    // chains and at most as many as the card holds at once
    BABBLE_CHECK(cudaFuncSetAttribute(walk_chunk_cluster,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = (unsigned)k;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)k);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    int resident = 0;
    BABBLE_CHECK(cudaOccupancyMaxActiveClusters(&resident, walk_chunk_cluster, &cfg));
    const int groups = (n + chains - 1) / chains;
    const int clusters = resident < groups ? resident : groups;
    if (clusters < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cfg.gridDim = dim3((unsigned)(clusters * k));
    cfg.numAttrs = 2;
    BABBLE_CHECK(cudaLaunchKernelEx(&cfg, walk_chunk_cluster, inv, rows_by, fd, la, x0, seeds,
                                    r_abs, first_nw, x_last, xs, scratch, n, l, e_fd, e_la,
                                    super_majority, length, steps, use_seeds, depth, cw, chains,
                                    slots));
    BABBLE_CHECK_LAUNCH();
    return 0;
}
