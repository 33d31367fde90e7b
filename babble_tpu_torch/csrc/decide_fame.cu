// decide_fame: Hashgraph virtual voting over the witness table.
//
// Replaces babble_tpu/tpu/kernels.py:335 _decide_fame (_fame_setup_tables
// and the while_loop of _decide_fame_tables), wide layout.
//
// Setup, one thread per (j, y, w):
//   ss[j, y, w]     = witness y of round j strongly sees witness w of round
//                     j-1: |{p : la[y][p] >= fd[w][p]}| >= super_majority
//                     (no round -1: the reference's roll wrap is masked)
//   votes0[i, y, x] = witness y of round i+1 has witness x of round i as an
//                     ancestor: la[y][x] >= index[x] (no round R: masked)
// Voting, one block per round i, the offset d looping inside the block:
//   yays[y, x] = sum_w ss[i+d, y, w] * votes[w, x]  (an integer loop; no
//   float product, so no TF32), nays = total - yays, first decision wins,
//   coin rounds (d % n == 0) take the voter's coin bit when not strong.
// Each round's votes evolve on their own, so a round stops as soon as it
// has no undecided witness with voters left. After that stop it could no
// longer decide anything, which makes the per-round exit give the same
// bits as the reference's global any(active) exit, with no host sync.
//
// Bound: bytes (the witness rows of la and fd, R * N * N int32 each, and
// the (R, N) outputs); the tally is N^3 small integer operations per round
// per offset, far below the card's rate. Votes live in a (R, 2, N, N)
// uint8 scratch the wrapper allocates (read back from L1/L2); per-round
// flags live in shared memory.

#include "common.cuh"

__global__ void fame_setup(const int32_t* __restrict__ wtable,
                           const int32_t* __restrict__ la,
                           const int32_t* __restrict__ fd,
                           const int32_t* __restrict__ index,
                           uint8_t* ss, uint8_t* votes,
                           int r_max, int n, int e, int super_majority) {
    long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long nn = (long long)n * n;
    if (k >= (long long)r_max * nn) return;
    int j = (int)(k / nn);
    int y = (int)((k / n) % n);
    int w = (int)(k % n);

    int wy = wtable[(long long)j * n + y];
    uint8_t s = 0;
    if (j > 0 && wy >= 0) {
        int ww = wtable[(long long)(j - 1) * n + w];
        if (ww >= 0) {
            const int32_t* la_y = la + (long long)babble_clamp(wy, 0, e - 1) * n;
            const int32_t* fd_w = fd + (long long)babble_clamp(ww, 0, e - 1) * n;
            int cnt = 0;
            for (int p = 0; p < n; ++p) cnt += la_y[p] >= fd_w[p];
            s = cnt >= super_majority;
        }
    }
    ss[k] = s;

    // votes0[j, y, x = w]: buffer 0 of round j's ping-pong pair
    uint8_t v = 0;
    if (j + 1 < r_max) {
        int wn = wtable[(long long)(j + 1) * n + y];
        if (wn >= 0) {
            int rx = babble_clamp(wtable[(long long)j * n + w], 0, e - 1);
            v = la[(long long)babble_clamp(wn, 0, e - 1) * n + w] >= index[rx];
        }
    }
    votes[(long long)j * 2 * nn + (long long)y * n + w] = v;
}

__global__ void fame_vote(const int32_t* __restrict__ wtable,
                          const uint8_t* __restrict__ coin_bit,
                          const int32_t* __restrict__ last_round,
                          const uint8_t* __restrict__ ss, uint8_t* votes,
                          uint8_t* decided, uint8_t* famous, uint8_t* rounds_decided,
                          int r_max, int n, int e, int super_majority,
                          int n_participants, int d_cap) {
    extern __shared__ int32_t smem[];
    int32_t* wv = smem;            // wvalid[i, x]
    int32_t* dec = wv + n;         // decided[i, x]
    int32_t* fam = dec + n;        // famous[i, x]
    int32_t* any_dec = fam + n;    // this step's decisions
    int32_t* any_fam = any_dec + n;
    int32_t* tot = any_fam + n;    // total[y] = sum_w ss[j, y, w]

    const int i = blockIdx.x;
    const long long nn = (long long)n * n;
    const int lr = *last_round;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        wv[x] = wtable[(long long)i * n + x] >= 0;
        dec[x] = fam[x] = any_dec[x] = any_fam[x] = 0;
    }
    __syncthreads();

    int cur = 0;
    for (int d = 2;; ++d) {
        int act = 0;
        if (i + d <= lr) {
            for (int x = threadIdx.x; x < n; x += blockDim.x) act |= wv[x] && !dec[x];
        }
        if (!__syncthreads_or(act) || d > d_cap) break;

        const int j = i + d;
        const bool j_ok = j <= lr;
        const int jc = babble_clamp(j, 0, r_max - 1);
        const uint8_t* ssj = ss + (long long)jc * nn;
        const uint8_t* vc = votes + ((long long)i * 2 + cur) * nn;
        uint8_t* vn = votes + ((long long)i * 2 + (cur ^ 1)) * nn;
        const int32_t* wt_j = wtable + (long long)jc * n;

        for (int y = threadIdx.x; y < n; y += blockDim.x) {
            int s = 0;
            if (j_ok) for (int w = 0; w < n; ++w) s += ssj[(long long)y * n + w];
            tot[y] = s;
        }
        __syncthreads();

        const bool is_coin = (d % n_participants) == 0;
        for (long long k = threadIdx.x; k < nn; k += blockDim.x) {
            int y = (int)(k / n), x = (int)(k % n);
            int yays = 0;
            if (j_ok) {
                const uint8_t* row = ssj + (long long)y * n;
                for (int w = 0; w < n; ++w) yays += row[w] & vc[(long long)w * n + x];
            }
            int nays = tot[y] - yays;
            bool v = yays >= nays;
            int t = v ? yays : nays;
            bool strong = t >= super_majority;
            int wy = wt_j[y];
            if (is_coin) {
                vn[k] = strong ? (uint8_t)v : coin_bit[babble_clamp(wy, 0, e - 1)];
            } else {
                vn[k] = v;
                if (strong && j_ok && wy >= 0 && wv[x] && !dec[x]) {
                    any_dec[x] = 1;  // benign race: every writer stores 1
                    if (v) any_fam[x] = 1;
                }
            }
        }
        __syncthreads();
        for (int x = threadIdx.x; x < n; x += blockDim.x) {
            if (any_dec[x]) {
                fam[x] = any_fam[x];
                dec[x] = 1;
                any_dec[x] = any_fam[x] = 0;
            }
        }
        cur ^= 1;
        __syncthreads();
    }

    int all_done = 1, any_valid = 0;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        decided[(long long)i * n + x] = dec[x];
        famous[(long long)i * n + x] = fam[x];
        all_done &= dec[x] || !wv[x];
        any_valid |= wv[x];
    }
    all_done = __syncthreads_and(all_done);
    any_valid = __syncthreads_or(any_valid);
    if (threadIdx.x == 0) rounds_decided[i] = all_done && any_valid;
}

extern "C" int babble_decide_fame(
    const int32_t* wtable, const int32_t* la, const int32_t* fd,
    const int32_t* index, const uint8_t* coin_bit, const int32_t* last_round,
    uint8_t* ss, uint8_t* votes, uint8_t* decided, uint8_t* famous,
    uint8_t* rounds_decided, int r_max, int n, int e, int super_majority,
    int n_participants, int d_cap, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long cells = (long long)r_max * n * n;
    fame_setup<<<babble_blocks(cells, 256), 256, 0, s>>>(
        wtable, la, fd, index, ss, votes, r_max, n, e, super_majority);
    BABBLE_CHECK_LAUNCH();
    size_t smem = (size_t)6 * n * sizeof(int32_t);
    if (smem > 48 * 1024) {
        BABBLE_CHECK(cudaFuncSetAttribute(
            fame_vote, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    }
    fame_vote<<<r_max, 256, smem, s>>>(
        wtable, coin_bit, last_round, ss, votes, decided, famous, rounds_decided,
        r_max, n, e, super_majority, n_participants, d_cap);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
