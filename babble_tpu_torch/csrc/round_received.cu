// round_received: DecideRoundReceived over the decided fame tables.
//
// Replaces babble_tpu/tpu/kernels.py:424 _decide_round_received
// (_received_tables_from, suffix_min, received_search, received_core).
//
//   famous_count[r] = |famous witnesses of round r|
//   min_la[r, c]    = min over famous witnesses w of round r of la[w][c]
//   i_ok[r]         = rounds_decided[r] and r <= last_round
//   horizon[k]      = first r >= k with not i_ok[r]   (R if none)
//   received(e)     = least i in (round(e), horizon[round(e)+1]) with
//                     famous_count[i] > 0, i_ok[i] and
//                     index(e) <= min_la[i, creator(e)];  -1 if none
//
// Three launches: tables (one block per round), the horizon (one thread,
// a reverse scan over R <= L + 2 entries), events (one thread per event,
// walking rounds upwards and stopping at the first hit).
//
// Bound: bytes. The function reads the witness rows of la (R * N * N
// int32), the (E,) index / creator / rounds and writes received (E,) once:
// about 1.8 MB at 65,536 padded events and R = N = 64.

#include "common.cuh"

__global__ void recv_tables(const int32_t* __restrict__ wtable,
                            const int32_t* __restrict__ la,
                            const uint8_t* __restrict__ decided,
                            const uint8_t* __restrict__ famous,
                            const uint8_t* __restrict__ rounds_decided,
                            const int32_t* __restrict__ last_round,
                            int32_t* min_la, int32_t* famous_count, uint8_t* i_ok,
                            int n, int e) {
    extern __shared__ int32_t frow[];  // (n,) la row of each famous witness, -1 if none
    const int r = blockIdx.x;
    __shared__ int total;
    if (threadIdx.x == 0) total = 0;
    __syncthreads();
    int local = 0;
    for (int w = threadIdx.x; w < n; w += blockDim.x) {
        long long k = (long long)r * n + w;
        int wt = wtable[k];
        bool f = decided[k] && famous[k] && wt >= 0;
        frow[w] = f ? babble_clamp(wt, 0, e - 1) : -1;
        local += f;
    }
    if (local) atomicAdd(&total, local);
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        int m = BABBLE_MAX_INT32;
        for (int w = 0; w < n; ++w) {
            int row = frow[w];
            if (row >= 0) m = min(m, la[(long long)row * n + c]);
        }
        min_la[(long long)r * n + c] = m;
    }
    if (threadIdx.x == 0) {
        famous_count[r] = total;
        i_ok[r] = rounds_decided[r] && r <= *last_round;
    }
}

__global__ void recv_horizon(const uint8_t* __restrict__ i_ok, int32_t* horizon, int r_max) {
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    int h = r_max;
    for (int r = r_max - 1; r >= 0; --r) {
        if (!i_ok[r]) h = r;
        horizon[r] = h;
    }
}

__global__ void recv_events(const int32_t* __restrict__ index,
                            const int32_t* __restrict__ creator,
                            const int32_t* __restrict__ rounds,
                            const int32_t* __restrict__ min_la,
                            const int32_t* __restrict__ famous_count,
                            const uint8_t* __restrict__ i_ok,
                            const int32_t* __restrict__ horizon,
                            int32_t* received, int r_max, int n, int e) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= e) return;
    int rd = rounds[k];
    int c = babble_clamp(creator[k], 0, n - 1);
    int idx = index[k];
    int hs = horizon[babble_clamp(rd + 1, 0, r_max - 1)];
    int stop = min(hs, r_max);
    int res = -1;
    for (int i = max(rd + 1, 0); i < stop; ++i) {
        if (famous_count[i] > 0 && i_ok[i] && idx <= min_la[(long long)i * n + c]) {
            res = i;
            break;
        }
    }
    received[k] = res;
}

extern "C" int babble_round_received(
    const int32_t* wtable, const int32_t* la, const int32_t* index,
    const int32_t* creator, const int32_t* rounds, const uint8_t* decided,
    const uint8_t* famous, const uint8_t* rounds_decided,
    const int32_t* last_round, int32_t* min_la, int32_t* famous_count,
    uint8_t* i_ok, int32_t* horizon, int32_t* received,
    int r_max, int n, int e, int e_la, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    size_t smem = (size_t)n * sizeof(int32_t);
    if (smem > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            recv_tables, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    }
    recv_tables<<<r_max, 128, smem, s>>>(
        wtable, la, decided, famous, rounds_decided, last_round,
        min_la, famous_count, i_ok, n, e_la);
    BABBLE_CHECK_LAUNCH();
    recv_horizon<<<1, 32, 0, s>>>(i_ok, horizon, r_max);
    BABBLE_CHECK_LAUNCH();
    if (e > 0) {
        recv_events<<<babble_blocks(e, 256), 256, 0, s>>>(
            index, creator, rounds, min_la, famous_count, i_ok, horizon,
            received, r_max, n, e);
        BABBLE_CHECK_LAUNCH();
    }
    return 0;
}
