// apply_deltas: the shared front half of the incremental append bodies,
// launched on its own.
//
// Replaces babble_tpu/tpu/incremental.py:213 _apply_deltas_and_stage
// (apply_deltas.cuh states the arithmetic and its bound). The step paths
// run the same device function as the first phase of step_levels.cu's
// walk; this launch serves the train paths, whose level kernels
// (train_levels.cu tl_init) read K9's fd_w mirror in a launch of their
// own. One grid-stride launch.

#include "apply_deltas.cuh"

__global__ void ad_apply(int32_t* fd, int32_t* fd_w, int32_t* la, int32_t* creator,
                         int32_t* index, const int32_t* __restrict__ w_of_row,
                         const int32_t* __restrict__ rows, const int32_t* __restrict__ b_creator,
                         const int32_t* __restrict__ b_index,
                         const int32_t* __restrict__ la_rows,
                         const int32_t* __restrict__ upd_row,
                         const int32_t* __restrict__ upd_col,
                         const int32_t* __restrict__ upd_val, int e_cap, int n, int r_cap,
                         int b, int u) {
    babble_apply_deltas_range(fd, fd_w, la, creator, index, w_of_row, rows, b_creator, b_index,
                              la_rows, upd_row, upd_col, upd_val, e_cap, n, r_cap, b, u,
                              (long long)blockIdx.x * blockDim.x + threadIdx.x,
                              (long long)gridDim.x * blockDim.x);
}

extern "C" int babble_apply_deltas(
    int32_t* fd, int32_t* fd_w, int32_t* la, int32_t* creator, int32_t* index,
    const int32_t* w_of_row, const int32_t* rows, const int32_t* b_creator,
    const int32_t* b_index, const int32_t* la_rows, const int32_t* upd_row,
    const int32_t* upd_col, const int32_t* upd_val,
    int e_cap, int n, int r_cap, int b, int u, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // babble_apply_deltas_range's work items: delta and staging items in
    // pairs, four to an item where the arrays allow 16-byte accesses
    const bool vd = (u & 3) == 0 && babble_rows_aligned16(upd_row, 4) &&
                    babble_rows_aligned16(upd_col, 4) && babble_rows_aligned16(upd_val, 4);
    const bool vs = babble_rows_aligned16(la, n) && babble_rows_aligned16(la_rows, n);
    const long long n_d = vd ? u / 4 : u;
    const long long n_s = (long long)b * (vs ? n / 4 : n);
    const long long total = n_d > n_s ? n_d : n_s;
    if (total > 0) {
        ad_apply<<<babble_stride_blocks(total, 256), 256, 0, s>>>(
            fd, fd_w, la, creator, index, w_of_row, rows, b_creator, b_index,
            la_rows, upd_row, upd_col, upd_val, e_cap, n, r_cap, b, u);
        BABBLE_CHECK_LAUNCH();
    }
    return 0;
}
