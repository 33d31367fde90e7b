// The body of K9 apply_deltas (babble_tpu/tpu/incremental.py:213
// _apply_deltas_and_stage), as a device function over a grid-stride range,
// so that apply_deltas.cu launches it on its own (the train paths) and
// step_levels.cu runs it as the first phase of its level walk (the step
// paths). In place, for one batch or train:
//   fd[upd_row[u], upd_col[u]]          = min(., upd_val[u])   for each delta u
//   fd_w[w_of_row[upd_row[u]], upd_col[u]] = min(., upd_val[u]) where the row
//                                          is a registered witness
//   la[rows[i]] = la_rows[i], creator[rows[i]] = b_creator[i],
//   index[rows[i]] = b_index[i], fd[rows[i], b_creator[i]] = min(., b_index[i])
// Out-of-range targets (row E_cap marks a padding delta, row -1 a padding
// slot) are dropped, as JAX's mode="drop" drops them.
//
// Each fd cell is written at most once ever, so the min-scatter is
// order-free: atomicMin, four deltas a thread. The mirror reads
// w_of_row, which this function never writes, so it sees the slot map as it
// stood before the batch, provided the caller writes w_of_row only after
// every thread has left this function (in-batch witnesses copy their fd
// row when they register, in the level kernels). The min-scatters are
// atomics, which act in L2; a caller that reads fd or fd_w afterwards in
// the same launch reads through L2 (__ldcg, cp.async.cg).
//
// Bound: bytes. Each real delta reads 12 bytes, its slot (4) and
// read-modify-writes one fd cell and at most one fd_w cell; each staged
// row reads and writes N + 2 words.

#pragma once

#include "common.cuh"

// Work items from `first` in steps of `stride`: item k takes delta item k
// (four deltas where the three delta arrays allow 16-byte loads, u a
// multiple of 4, else one) and staging item k (four coordinates of a
// staged row where la and la_rows allow it, n a multiple of 4, else one),
// their loads issued together before the slot map's and before the
// atomics and stores, so that a thread's round trips overlap.
__device__ __forceinline__ void babble_apply_deltas_range(
    int32_t* fd, int32_t* fd_w, int32_t* la, int32_t* creator, int32_t* index,
    const int32_t* w_of_row, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ b_creator, const int32_t* __restrict__ b_index,
    const int32_t* __restrict__ la_rows, const int32_t* __restrict__ upd_row,
    const int32_t* __restrict__ upd_col, const int32_t* __restrict__ upd_val, int e_cap,
    int n, int r_cap, int b, int u, long long first, long long stride) {
    const long long slots = (long long)r_cap * n;
    const bool vd = (u & 3) == 0 && babble_rows_aligned16(upd_row, 4) &&
                    babble_rows_aligned16(upd_col, 4) && babble_rows_aligned16(upd_val, 4);
    const bool vs = babble_rows_aligned16(la, n) && babble_rows_aligned16(la_rows, n);
    const long long n_d = vd ? u / 4 : u;
    const int per_row = vs ? n / 4 : n;
    const long long n_s = (long long)b * per_row;
    const long long items = n_d > n_s ? n_d : n_s;
    for (long long k = first; k < items; k += stride) {
        // loads: the deltas, the staged row's target and coordinates
        int r[4] = {-1, -1, -1, -1}, c[4] = {0, 0, 0, 0}, v[4] = {0, 0, 0, 0};
        if (k < n_d && vd) {
            const int4 r4 = reinterpret_cast<const int4*>(upd_row)[k];
            const int4 c4 = reinterpret_cast<const int4*>(upd_col)[k];
            const int4 v4 = reinterpret_cast<const int4*>(upd_val)[k];
            r[0] = r4.x, r[1] = r4.y, r[2] = r4.z, r[3] = r4.w;
            c[0] = c4.x, c[1] = c4.y, c[2] = c4.z, c[3] = c4.w;
            v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
        } else if (k < n_d) {
            r[0] = upd_row[k], c[0] = upd_col[k], v[0] = upd_val[k];
        }
        const bool staged = k < n_s;
        const int i = staged ? (int)(k / per_row) : 0, p = staged ? (int)(k % per_row) : 0;
        const int srow = staged ? rows[i] : -1;
        int4 q4 = make_int4(0, 0, 0, 0);
        if (staged && vs) q4 = reinterpret_cast<const int4*>(la_rows + (long long)i * n)[p];
        else if (staged) q4.x = la_rows[(long long)i * n + p];
        // the pre-batch slots of the deltas' rows
        int s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (r[j] < 0 || r[j] >= e_cap || c[j] < 0 || c[j] >= n) r[j] = -1;
            s[j] = r[j] >= 0 ? w_of_row[r[j]] : -1;
        }
        // writes
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (r[j] < 0) continue;
            atomicMin(&fd[(long long)r[j] * n + c[j]], v[j]);
            if (s[j] >= 0 && s[j] < slots) atomicMin(&fd_w[(long long)s[j] * n + c[j]], v[j]);
        }
        if (srow < 0 || srow >= e_cap) continue;
        if (vs) reinterpret_cast<int4*>(la + (long long)srow * n)[p] = q4;
        else la[(long long)srow * n + p] = q4.x;
        if (p == 0) {
            const int cr = b_creator[i], idx = b_index[i];
            creator[srow] = cr;
            index[srow] = idx;
            if (cr >= 0 && cr < n) atomicMin(&fd[(long long)srow * n + cr], idx);
        }
    }
}
