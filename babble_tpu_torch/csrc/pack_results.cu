// pack_results: every field the live engine's host write-back reads,
// flattened into one int32 vector so that a call fetches once.
//
// Replaces babble_tpu/tpu/live.py:757 _pack_results. With
// lo' = clamp(lo < 0 ? lo + e_cap : lo, 0, e_cap - e_win) (where
// jax.lax.dynamic_slice places its start) and R = r_cap * n, the output of
// 4 * e_win + 3 * R + 3 words is, in order:
//   rounds[lo' .. lo' + e_win), lamport[..], witness[..] (0/1), received[..],
//   wtable (R, row-major), fame_decided (R, 0/1), famous (R, 0/1),
//   stale (0/1), fame_lag (0/1), last_round.
// The three scalars are read on the device: nothing is read back first.
//
// One grid-stride launch: output word i finds its segment and reads its
// one source element. Bound: bytes (each source read once, each output
// word written once); at the live engine's defaults it is launch-bound.
// The live engine launches it only where no decide ran since its last
// fetch (a call with no new events, an attach from the frontier): a
// decide handed a vector writes this layout in K12's last two launches
// (decide_window.cu dw_tables, dw_events).

#include "common.cuh"

__global__ void pr_pack(const int32_t* __restrict__ rounds,
                        const int32_t* __restrict__ lamport,
                        const uint8_t* __restrict__ witness,
                        const int32_t* __restrict__ received,
                        const int32_t* __restrict__ wtable,
                        const uint8_t* __restrict__ fame_decided,
                        const uint8_t* __restrict__ famous,
                        const uint8_t* __restrict__ stale,
                        const uint8_t* __restrict__ fame_lag,
                        const int32_t* __restrict__ last_round,
                        int32_t* __restrict__ out,
                        int lo, int e_win, long long r_n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long rows = 4LL * e_win;
    const long long total = rows + 3 * r_n + 3;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        int32_t v;
        if (i < rows) {
            const int seg = (int)(i / e_win);
            const long long r = lo + i % e_win;
            switch (seg) {
                case 0: v = rounds[r]; break;
                case 1: v = lamport[r]; break;
                case 2: v = witness[r] != 0; break;
                default: v = received[r]; break;
            }
        } else if (i < rows + 3 * r_n) {
            const long long k = i - rows;
            const int seg = (int)(k / r_n);
            const long long q = k % r_n;
            v = seg == 0 ? wtable[q] : (seg == 1 ? fame_decided[q] != 0 : famous[q] != 0);
        } else {
            const long long f = i - rows - 3 * r_n;
            v = f == 0 ? (*stale != 0) : (f == 1 ? (*fame_lag != 0) : *last_round);
        }
        out[i] = v;
    }
}

extern "C" int babble_pack_results(
    const int32_t* rounds, const int32_t* lamport, const uint8_t* witness,
    const int32_t* received, const int32_t* wtable, const uint8_t* fame_decided,
    const uint8_t* famous, const uint8_t* stale, const uint8_t* fame_lag,
    const int32_t* last_round, int32_t* out,
    int lo, int e_cap, int e_win, int r_cap, int n, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (e_win < 0 || e_win > e_cap) return (int)cudaErrorInvalidValue;
    const long long lo_w = lo < 0 ? (long long)lo + e_cap : lo;
    const int lo_c = (int)(lo_w < 0 ? 0 : (lo_w > e_cap - e_win ? e_cap - e_win : lo_w));
    const long long r_n = (long long)r_cap * n;
    const long long total = 4LL * e_win + 3 * r_n + 3;
    pr_pack<<<babble_stride_blocks(total, 256), 256, 0, s>>>(
        rounds, lamport, witness, received, wtable, fame_decided, famous,
        stale, fame_lag, last_round, out, lo_c, e_win, r_n);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
