// apply_deltas: the shared front half of the incremental append bodies.
//
// Replaces babble_tpu/tpu/incremental.py:213 _apply_deltas_and_stage.
// In place, for one batch or train:
//   fd[upd_row[u], upd_col[u]]          = min(., upd_val[u])   for each delta u
//   fd_w[w_of_row[upd_row[u]], upd_col[u]] = min(., upd_val[u]) where the row
//                                          is a registered witness
//   la[rows[i]] = la_rows[i], creator[rows[i]] = b_creator[i],
//   index[rows[i]] = b_index[i], fd[rows[i], b_creator[i]] = min(., b_index[i])
// Out-of-range targets (row E_cap marks a padding delta, row -1 a padding
// slot) are dropped, as JAX's mode="drop" drops them.
//
// Each fd cell is written at most once ever, so the min-scatter is
// order-free: one thread per delta with atomicMin. The mirror reads
// w_of_row, which this kernel never writes, so it sees the slot map as it
// stood before the batch (in-batch witnesses copy their fd row when they
// register, in the level kernels).
//
// Bound: bytes. Each real delta reads 12 bytes, its slot (4) and
// read-modify-writes one fd cell and at most one fd_w cell; each staged
// row reads and writes N + 2 words. One grid-stride launch.

#include "common.cuh"

__global__ void ad_apply(int32_t* fd, int32_t* fd_w, int32_t* la,
                         int32_t* creator, int32_t* index,
                         const int32_t* __restrict__ w_of_row,
                         const int32_t* __restrict__ rows,
                         const int32_t* __restrict__ b_creator,
                         const int32_t* __restrict__ b_index,
                         const int32_t* __restrict__ la_rows,
                         const int32_t* __restrict__ upd_row,
                         const int32_t* __restrict__ upd_col,
                         const int32_t* __restrict__ upd_val,
                         int e_cap, int n, int r_cap, int b, int u) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long total = (long long)u + (long long)b * n;
    const long long slots = (long long)r_cap * n;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         k < total; k += stride) {
        if (k < u) {
            const int r = upd_row[k], c = upd_col[k];
            if (r < 0 || r >= e_cap || c < 0 || c >= n) continue;
            const int v = upd_val[k];
            atomicMin(&fd[(long long)r * n + c], v);
            const int s = w_of_row[r];
            if (s >= 0 && s < slots) atomicMin(&fd_w[(long long)s * n + c], v);
        } else {
            const long long q = k - u;
            const int i = (int)(q / n), p = (int)(q % n);
            const int r = rows[i];
            if (r < 0 || r >= e_cap) continue;
            la[(long long)r * n + p] = la_rows[q];
            if (p == 0) {
                const int c = b_creator[i], idx = b_index[i];
                creator[r] = c;
                index[r] = idx;
                if (c >= 0 && c < n) atomicMin(&fd[(long long)r * n + c], idx);
            }
        }
    }
}

extern "C" int babble_apply_deltas(
    int32_t* fd, int32_t* fd_w, int32_t* la, int32_t* creator, int32_t* index,
    const int32_t* w_of_row, const int32_t* rows, const int32_t* b_creator,
    const int32_t* b_index, const int32_t* la_rows, const int32_t* upd_row,
    const int32_t* upd_col, const int32_t* upd_val,
    int e_cap, int n, int r_cap, int b, int u, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long total = (long long)u + (long long)b * n;
    if (total > 0) {
        ad_apply<<<babble_stride_blocks(total, 256), 256, 0, s>>>(
            fd, fd_w, la, creator, index, w_of_row, rows, b_creator, b_index,
            la_rows, upd_row, upd_col, upd_val, e_cap, n, r_cap, b, u);
        BABBLE_CHECK_LAUNCH();
    }
    return 0;
}
