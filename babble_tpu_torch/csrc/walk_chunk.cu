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
// walk_chunk_block, up to 32 validators: one block. The frontier, m0 and
// the frontier rows' fd table stay in shared memory for the whole chunk;
// the table is kept transposed, fdT[p * ld + w] with ld = N rounded up to
// odd, so that lanes reading the rows of consecutive witnesses w at one
// coordinate p hit different banks. Per step: one warp per frontier row
// loads its fd row (lanes over p, coalesced) into the table; a barrier;
// one warp per chain runs its binary search (the probed la row cached per
// warp in shared memory, lanes count over the frontier rows, a warp sum
// gives the predicate); a barrier; one warp per chain takes the
// cross-chain closure as a warp minimum over INV and writes X(r+1); a
// barrier.
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
// Launches per call (one chunk): one.

#include "common.cuh"

// largest dynamic shared memory one block may use on an H100
#define WC_MAX_SMEM 232448
// walk_chunk_block up to this many validators
#define WC_BLOCK_MAX 32

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

__global__ void walk_chunk_block(const int32_t* __restrict__ inv,
                                 const int32_t* __restrict__ rows_by,
                                 const int32_t* __restrict__ fd,
                                 const int32_t* __restrict__ la,
                                 const int32_t* __restrict__ x0,
                                 const int32_t* __restrict__ seeds,
                                 const int32_t* __restrict__ r_abs,
                                 const int32_t* __restrict__ first_nw,
                                 int32_t* x_last, int32_t* xs,
                                 int n, int l, int e_fd, int e_la,
                                 int super_majority, int length, int steps,
                                 int use_seeds) {
    extern __shared__ int32_t smem[];
    int32_t* xc = smem;            // (n,) the frontier X(r)
    int32_t* m0 = xc + n;          // (n,)
    int32_t* wok = m0 + n;         // (n,) countable frontier rows
    int32_t* clen = wok + n;       // (n,) chain lengths
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int32_t* la_mid = clen + n + warp * n;  // (n,) this warp's probe row
    const int ld = n | 1;
    // (n, ld) frontier rows' fd, transposed, after the probe rows
    int32_t* fdT = clen + n + n_warps * n;

    for (int c = warp; c < n; c += n_warps) {
        int cnt = 0;
        for (int i = lane; i < l; i += 32) cnt += rows_by[(long long)c * l + i] >= 0;
        cnt = __reduce_add_sync(BABBLE_FULL_MASK, cnt);
        if (lane == 0) clen[c] = cnt;
    }
    for (int c = threadIdx.x; c < n; c += blockDim.x) xc[c] = x0[c];
    __syncthreads();

    for (int k = 0; k < length; ++k) {
        const int r_cur = r_abs[k];
        // the frontier rows and their fd vectors, one warp per row
        for (int w = warp; w < n; w += n_warps) {
            const int x = xc[w];
            bool ok = x < l;
            if (use_seeds) ok = ok && !(x == 0 && r_cur == first_nw[w]);
            const int row = ok ? babble_clamp(
                rows_by[(long long)w * l + babble_clamp(x, 0, l - 1)], 0, e_fd - 1) : 0;
            for (int p = lane; p < n; p += 32) {
                fdT[p * ld + w] = ok ? fd[(long long)row * n + p] : BABBLE_MAX_INT32;
            }
            if (lane == 0) wok[w] = ok;
        }
        __syncthreads();
        // m0: one warp per chain, exactly `steps` probes from lo = X[c]
        for (int c = warp; c < n; c += n_warps) {
            const int len = clen[c];
            const int last = max(len - 1, 0);
            int lo = babble_clamp(xc[c], 0, l), hi = l;
            for (int s = 0; s < steps; ++s) {
                const int mid = min((lo + hi) / 2, l - 1);
                const int probe = min(mid, last);
                const int ev = babble_clamp(rows_by[(long long)c * l + probe], 0, e_la - 1);
                for (int p = lane; p < n; p += 32) la_mid[p] = la[(long long)ev * n + p];
                __syncwarp();
                int seen = 0;
                for (int w = lane; w < n; w += 32) {
                    if (!wok[w]) continue;
                    int cnt = 0;
                    for (int p = 0; p < n; ++p) cnt += la_mid[p] >= fdT[p * ld + w];
                    seen += cnt >= super_majority;
                }
                seen = __reduce_add_sync(BABBLE_FULL_MASK, seen);
                if (seen >= super_majority && len > 0) hi = min(mid, hi);
                else lo = mid + 1;
                __syncwarp();
            }
            if (lane == 0) m0[c] = hi < len ? hi : l;
        }
        __syncthreads();
        // cross-chain closure, seed row, clamp; chain c's warp alone reads
        // and writes xc[c] here
        for (int c = warp; c < n; c += n_warps) {
            int r = l;
            const int32_t* inv_c = inv + (long long)c * n * l;
            for (int x = lane; x < n; x += 32) {
                const int mx = m0[x];
                if (mx < l) r = min(r, inv_c[(long long)x * l + babble_clamp(mx, 0, l - 1)]);
            }
            r = __reduce_min_sync(BABBLE_FULL_MASK, r);
            if (lane == 0) {
                int xn = min(m0[c], r);
                if (use_seeds) xn = min(xn, seeds[(long long)k * n + c]);
                xn = min(max(xn, xc[c]), l);
                xs[(long long)k * n + c] = xn;
                xc[c] = xn;
            }
        }
        __syncthreads();
    }
    for (int c = threadIdx.x; c < n; c += blockDim.x) x_last[c] = xc[c];
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

extern "C" int babble_walk_chunk(
    const int32_t* inv, const int32_t* rows_by, const int32_t* fd,
    const int32_t* la, const int32_t* x0, const int32_t* seeds,
    const int32_t* r_abs, const int32_t* first_nw, int32_t* x_last,
    int32_t* xs, int32_t* scratch, int n, int l, int e_fd, int e_la,
    int super_majority, int length, int steps, int use_seeds, int device,
    void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= WC_BLOCK_MAX) {
        // the frontier, m0, wok, the chain lengths, a probe row per warp
        // and the (n, n | 1) table: under 9 KB
        const size_t smem = ((size_t)4 * n + (size_t)n * n + (size_t)n * (n | 1))
                            * sizeof(int32_t);
        walk_chunk_block<<<1, 32 * n, smem, s>>>(
            inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last, xs, n, l, e_fd, e_la,
            super_majority, length, steps, use_seeds);
        BABBLE_CHECK_LAUNCH();
        return 0;
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
