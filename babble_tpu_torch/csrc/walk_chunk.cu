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
// Design: one launch per chunk, one block. The frontier, fd_w (N x N, rows
// padded to N + 1 words so that lanes reading one column of different rows
// hit different banks) and m0 stay in shared memory for the whole chunk.
// Per step: all threads load fd_w; a barrier; one warp per chain runs its
// binary search (the probed la row is cached per warp in shared memory,
// lanes count over the frontier rows, a warp sum gives the predicate); a
// barrier; one warp per chain takes the cross-chain closure as a warp
// minimum over INV and writes X(r+1); a barrier.
//
// Launches per call (one chunk): one.

#include "common.cuh"

#define WC_MAX_WARPS 32

__global__ void walk_chunk_kernel(const int32_t* __restrict__ inv,
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
    int32_t* fdw = clen + n;       // (n, n + 1) frontier rows' fd, padded
    const int ld = n + 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int32_t* la_mid = fdw + n * ld + warp * n;  // (n,) this warp's probe row

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
        // the frontier rows and their fd vectors
        for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
            const int w = t / n, p = t % n;
            const int x = xc[w];
            bool ok = x < l;
            if (use_seeds) ok = ok && !(x == 0 && r_cur == first_nw[w]);
            int v = BABBLE_MAX_INT32;
            if (ok) {
                const int row = babble_clamp(
                    rows_by[(long long)w * l + babble_clamp(x, 0, l - 1)], 0, e_fd - 1);
                v = fd[(long long)row * n + p];
            }
            fdw[w * ld + p] = v;
            if (p == 0) wok[w] = ok;
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
                    const int32_t* f = fdw + w * ld;
                    int cnt = 0;
                    for (int p = 0; p < n; ++p) cnt += la_mid[p] >= f[p];
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

extern "C" int babble_walk_chunk(
    const int32_t* inv, const int32_t* rows_by, const int32_t* fd,
    const int32_t* la, const int32_t* x0, const int32_t* seeds,
    const int32_t* r_abs, const int32_t* first_nw, int32_t* x_last,
    int32_t* xs, int n, int l, int e_fd, int e_la, int super_majority,
    int length, int steps, int use_seeds, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int warps = n < WC_MAX_WARPS ? n : WC_MAX_WARPS;
    const size_t smem = ((size_t)4 * n + (size_t)n * (n + 1) + (size_t)warps * n) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            walk_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    }
    walk_chunk_kernel<<<1, 32 * warps, smem, s>>>(
        inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last, xs, n, l,
        e_fd, e_la, super_majority, length, steps, use_seeds);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
