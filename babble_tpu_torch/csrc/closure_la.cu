// closure_la: lastAncestors by pointer doubling, one pass per call.
//
// Replaces babble_tpu/tpu/doubling.py:172 _closure_la (a while_loop of
// chain-prefix + squaring passes over the parent successor tables). With
// every coordinate a per-chain index:
//   la0[e, q]  = index(e) if creator(e) = q, and each parent's own
//                coordinate on the parent's chain (-1 elsewhere);
//   pass:  pre = la, each row replaced by the prefix max down its
//                self-chain (rows with index < 0 keep theirs);
//          la'[e, q] = max(pre[e, q], max over p with pre[e, p] >= 0 of
//                          pre[rows_by[p, pre[e, p]], q]);
//          changed = any(la' != la)   (against the iterate BEFORE the prefix)
// until nothing changes or pass_cap passes have run; the pass count is part
// of the result.
//
// Bound: operations, and the passes are dependent. A pass does N*l*N
// maxima for the prefix and up to E*N*N for the squaring, against E*N int32
// of output; at 64 validators and 65,536 rows that is up to 268 M maxima per
// pass, about 4 us at 67 T/s, while the function's own bytes (the parent
// tables in, la out) take about 5 us for all passes together.
// Design, per pass: (1) one warp per (chain, coordinate) column runs the
// inclusive max scan down the chain in 32-wide chunks with a shuffle scan
// and a carry, into a scratch table lat (N, N, l) (coalesced along the
// chain); (2) each row picks its prefix from lat; (3) one warp per row
// squares: for each p the warp reads the target row's vector coalesced
// along q. The squaring writes a second buffer: every row reads the
// previous iterate, as the reference's blocked map does (squaring in place
// would change the intermediate iterates, and with them the pass count).
// A flag, cleared before the squaring and set by any warp whose row
// changed, is read by the host once per pass.
//
// Launches per call (one pass): three, four on the first (init).

#include "common.cuh"

// la0: own coordinate + both parents' own coordinates
__global__ void cl_init(const int32_t* __restrict__ creator,
                        const int32_t* __restrict__ index,
                        const int32_t* __restrict__ sp,
                        const int32_t* __restrict__ op,
                        int32_t* la0, int e, int n) {
    long long total = (long long)e * n;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        const int ev = (int)(k / n), q = (int)(k % n);
        int v = -1;
        const int idx = index[ev];
        if (creator[ev] == q && idx >= 0) v = idx;
        const int s = sp[ev];
        if (s >= 0) {
            const int r = min(s, e - 1);
            if (creator[r] == q) v = max(v, index[r]);
        }
        const int o = op[ev];
        if (o >= 0) {
            const int r = min(o, e - 1);
            if (creator[r] == q) v = max(v, index[r]);
        }
        la0[k] = v;
    }
}

// lat[c, p, i] = max over i' <= i of la[rows_by[c, i'], p] (-1 for an empty
// slot); one warp per (c, p)
__global__ void cl_prefix(const int32_t* __restrict__ rows_by,
                          const int32_t* __restrict__ la,
                          int32_t* lat, int n, int l, int e) {
    const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (gw >= (long long)n * n) return;  // warp-uniform
    const int c = (int)(gw / n), p = (int)(gw % n);
    const int32_t* rb = rows_by + (long long)c * l;
    int32_t* out = lat + gw * l;
    int carry = -1;
    for (int i0 = 0; i0 < l; i0 += 32) {
        const int i = i0 + lane;
        int v = -1;
        if (i < l) {
            const int row = rb[i];
            if (row >= 0) v = la[(long long)min(row, e - 1) * n + p];
        }
        for (int off = 1; off < 32; off <<= 1) {
            const int t = __shfl_up_sync(BABBLE_FULL_MASK, v, off);
            if (lane >= off) v = max(v, t);
        }
        v = max(v, carry);
        if (i < l) out[i] = v;
        carry = __shfl_sync(BABBLE_FULL_MASK, v, 31);
    }
}

// pre[e, q] = lat[creator(e), q, index(e)] for index(e) >= 0, else la[e, q]
__global__ void cl_gather(const int32_t* __restrict__ creator,
                          const int32_t* __restrict__ index,
                          const int32_t* __restrict__ la,
                          const int32_t* __restrict__ lat,
                          int32_t* pre, int e, int n, int l) {
    long long total = (long long)e * n;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        const int ev = (int)(k / n), q = (int)(k % n);
        const int idx = index[ev];
        if (idx >= 0) {
            const int c = babble_clamp(creator[ev], 0, n - 1);
            pre[k] = lat[((long long)c * n + q) * l + min(idx, l - 1)];
        } else {
            pre[k] = la[k];
        }
    }
}

// one warp per row: la_next[e] = max(pre[e], pre[target rows]); flag if
// la_next[e] != la[e]
__global__ void cl_square(const int32_t* __restrict__ rows_by,
                          const int32_t* __restrict__ la,
                          const int32_t* __restrict__ pre,
                          int32_t* la_next, int32_t* flag, int e, int n, int l) {
    const long long ev = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (ev >= e) return;  // warp-uniform
    const int32_t* prow = pre + ev * n;
    bool diff = false;
    for (int q0 = 0; q0 < n; q0 += 32) {
        const int q = q0 + lane;
        int v = q < n ? prow[q] : -1;
        for (int p = 0; p < n; ++p) {
            const int x = prow[p];
            if (x < 0) continue;  // warp-uniform
            const int t = max(rows_by[(long long)p * l + min(x, l - 1)], 0);
            if (q < n) v = max(v, pre[(long long)min(t, e - 1) * n + q]);
        }
        if (q < n) {
            la_next[ev * n + q] = v;
            diff |= v != la[ev * n + q];
        }
    }
    if (__any_sync(BABBLE_FULL_MASK, diff) && lane == 0) atomicOr(flag, 1);
}

extern "C" int babble_closure_la_pass(
    const int32_t* creator, const int32_t* index, const int32_t* sp,
    const int32_t* op, const int32_t* rows_by, int32_t* la, int32_t* lat,
    int32_t* pre, int32_t* la_next, int32_t* flag,
    int e, int n, int l, int init, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long cells = (long long)e * n;
    if (init) {
        cl_init<<<babble_stride_blocks(cells, 256), 256, 0, s>>>(
            creator, index, sp, op, la, e, n);
        BABBLE_CHECK_LAUNCH();
    }
    cl_prefix<<<babble_blocks((long long)n * n * 32, 256), 256, 0, s>>>(
        rows_by, la, lat, n, l, e);
    BABBLE_CHECK_LAUNCH();
    cl_gather<<<babble_stride_blocks(cells, 256), 256, 0, s>>>(
        creator, index, la, lat, pre, e, n, l);
    BABBLE_CHECK_LAUNCH();
    BABBLE_CHECK(cudaMemsetAsync(flag, 0, sizeof(int32_t), s));
    cl_square<<<babble_blocks((long long)e * 32, 256), 256, 0, s>>>(
        rows_by, la, pre, la_next, flag, e, n, l);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
