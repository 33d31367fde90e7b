// frontier_append: one append train into the frontier-live engine's tables.
//
// Replaces babble_tpu/tpu/frontier_live.py:113 _append_train. In place,
// for the train's KB rows (row < 0 = padding; `valid` = row >= 0):
//   INV:      for each valid event e of creator c in [0, N) and coordinate
//             p whose la[e, p] >= 0 advanced past its self-parent's (the
//             in-train parent's la row for sp_pos >= 0, else the state's
//             row sp_row as it stood before this train, -1 outside
//             [0, E_cap)):  INV[c, p, min(la[e, p], L-1)] = min(., index[e]);
//             then the suffix-min along the value axis of every plane
//             (c, p) of a dirty chain;
//   staging:  la, creator, index, lamport and coin of each valid row below
//             E_cap;
//   rows_by:  rows_by[c, clip(index, 0, L-1)] = row for each valid event,
//             so past the index axis (index >= L) the last cell is
//             overwritten, as the reference's clipped scatter does; where
//             several events of one chain land on that cell the last in
//             train order wins, as the reference's scatter applies its
//             updates in order;
//   flags:    dirty[c] for each valid event's chain, l_over if a valid
//             event's index >= L, count += the valid rows.
// A creator outside [0, N) drops its scatters (the reference drops c >= N;
// trains_from_grid never stages a negative one).
//
// Re-closing only the dirty chains' planes gives the reference's result,
// whose suffix-min runs over every plane: a plane no train touched since
// its last closure is closed already, and the closure is idempotent.
//
// Bound: bytes. The train's rows in (KB x (N + 8) int32) and the dirty
// planes read and written once (2 x dirty x N x L int32: 64 MiB each way
// at the bench cell's 64 chains of L = 4,096); the scatter is KB x N
// atomics into L2. Launches: fa_scatter (a thread per (event, coordinate),
// atomicMin), fa_rows (a thread per event: identity, rows_by, flags, one
// atomic per warp for the count), fa_stage (la rows), fa_close (a warp per
// dirty plane row, a chunked suffix-min from the top of the value axis,
// 32 values per step, the running minimum carried between chunks).

#include "common.cuh"

#define FA_THREADS 256

// la[e, p] of each event's self-parent before this train, -1 if none
__device__ __forceinline__ int fa_la_sp(const int32_t* la, const int32_t* t_la_rows,
                                        int sp_row, int sp_pos, int p, int n, int kb,
                                        int e_cap) {
    if (sp_pos >= 0) return t_la_rows[(long long)min(sp_pos, kb - 1) * n + p];
    if (sp_row >= 0 && sp_row < e_cap) return la[(long long)sp_row * n + p];
    return -1;
}

__global__ void fa_scatter(const int32_t* __restrict__ la, int32_t* inv,
                           int32_t* last_pos,
                           const int32_t* __restrict__ t_rows,
                           const int32_t* __restrict__ t_creator,
                           const int32_t* __restrict__ t_index,
                           const int32_t* __restrict__ t_sp_row,
                           const int32_t* __restrict__ t_sp_pos,
                           const int32_t* __restrict__ t_la_rows,
                           int e_cap, int n, int l, int kb) {
    const long long total = (long long)kb * n;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < total;
         k += stride) {
        const int e = (int)(k / n), p = (int)(k % n);
        const int c = t_creator[e];
        if (t_rows[e] < 0 || c < 0 || c >= n) continue;
        const int idx = t_index[e];
        if (p == 0 && idx >= l - 1) atomicMax(last_pos + c, e);
        const int v = t_la_rows[k];
        const int v_sp = fa_la_sp(la, t_la_rows, t_sp_row[e], t_sp_pos[e], p, n, kb, e_cap);
        if (v < 0 || v <= v_sp) continue;
        atomicMin(inv + ((long long)c * n + p) * l + min(v, l - 1), idx);
    }
}

__global__ void fa_rows(int32_t* creator, int32_t* index, int32_t* lamport,
                        uint8_t* coin, int32_t* rows_by, uint8_t* dirty,
                        int32_t* count, uint8_t* l_over,
                        const int32_t* __restrict__ last_pos,
                        const int32_t* __restrict__ t_rows,
                        const int32_t* __restrict__ t_creator,
                        const int32_t* __restrict__ t_index,
                        const int32_t* __restrict__ t_lamport,
                        const uint8_t* __restrict__ t_coin,
                        int e_cap, int n, int l, int kb) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    int valid = 0;
    if (e < kb) {
        const int row = t_rows[e];
        valid = row >= 0;
        if (valid) {
            const int c = t_creator[e], idx = t_index[e];
            if (row < e_cap) {
                creator[row] = c;
                index[row] = idx;
                lamport[row] = t_lamport[e];
                coin[row] = t_coin[e];
            }
            if (c >= 0 && c < n) {
                const int ci = babble_clamp(idx, 0, l - 1);
                if (ci < l - 1 || last_pos[c] == e) rows_by[(long long)c * l + ci] = row;
                dirty[c] = 1;  // benign race: every writer stores 1
            }
            if (idx >= l) *l_over = 1;
        }
    }
    const int cnt = __reduce_add_sync(BABBLE_FULL_MASK, valid);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(count, cnt);
}

__global__ void fa_stage(int32_t* la, const int32_t* __restrict__ t_rows,
                         const int32_t* __restrict__ t_la_rows, int e_cap, int n, int kb) {
    const long long total = (long long)kb * n;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < total;
         k += stride) {
        const int row = t_rows[k / n];
        if (row >= 0 && row < e_cap) la[(long long)row * n + k % n] = t_la_rows[k];
    }
}

// one warp per plane row (c, p) of a dirty chain c
__global__ void fa_close(int32_t* inv, const uint8_t* __restrict__ dirty, int n, int l) {
    const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (r >= (long long)n * n || !dirty[r / n]) return;  // warp-uniform
    int32_t* row = inv + r * l;
    int carry = BABBLE_MAX_INT32;
    for (int hi = l; hi > 0; hi -= 32) {
        const int i = hi - 32 + lane;
        int v = i >= 0 ? row[i] : BABBLE_MAX_INT32;
        // inclusive suffix minimum within the chunk: lane k takes the
        // minimum over lanes >= k (a lane past 31 returns its own value)
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            v = min(v, __shfl_down_sync(BABBLE_FULL_MASK, v, off));
        }
        v = min(v, carry);
        if (i >= 0) row[i] = v;
        carry = __shfl_sync(BABBLE_FULL_MASK, v, 0);
    }
}

extern "C" int babble_frontier_append(
    int32_t* la, int32_t* creator, int32_t* index, int32_t* lamport, uint8_t* coin,
    int32_t* rows_by, int32_t* inv, uint8_t* dirty, int32_t* count, uint8_t* l_over,
    int32_t* last_pos, const int32_t* t_rows, const int32_t* t_creator,
    const int32_t* t_index, const int32_t* t_lamport, const uint8_t* t_coin,
    const int32_t* t_sp_row, const int32_t* t_sp_pos, const int32_t* t_la_rows,
    int e_cap, int n, int l, int kb, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    BABBLE_CHECK(cudaMemsetAsync(last_pos, 0xff, (size_t)n * sizeof(int32_t), s));
    const long long cells = (long long)kb * n;
    fa_scatter<<<babble_stride_blocks(cells, FA_THREADS), FA_THREADS, 0, s>>>(
        la, inv, last_pos, t_rows, t_creator, t_index, t_sp_row, t_sp_pos, t_la_rows,
        e_cap, n, l, kb);
    BABBLE_CHECK_LAUNCH();
    fa_rows<<<babble_blocks(kb, FA_THREADS), FA_THREADS, 0, s>>>(
        creator, index, lamport, coin, rows_by, dirty, count, l_over, last_pos, t_rows,
        t_creator, t_index, t_lamport, t_coin, e_cap, n, l, kb);
    BABBLE_CHECK_LAUNCH();
    fa_stage<<<babble_stride_blocks(cells, FA_THREADS), FA_THREADS, 0, s>>>(
        la, t_rows, t_la_rows, e_cap, n, kb);
    BABBLE_CHECK_LAUNCH();
    fa_close<<<babble_blocks((long long)n * n * 32, FA_THREADS), FA_THREADS, 0, s>>>(
        inv, dirty, n, l);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
