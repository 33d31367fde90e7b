// decide_fame: Hashgraph virtual voting over the witness table.
//
// Replaces babble_tpu/tpu/kernels.py:335 _decide_fame (_fame_setup_tables
// and the while_loop of _decide_fame_tables), in both voting-table
// layouts: the wide one first, the packed one below.
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
//
// The packed layout (babble_tpu/tpu/kernels.py:209 and :256-317 with
// packed=True, tpu/packed.py) holds the voted-witness axis in uint32
// words, bit k of word w for witness 32 w + k:
//   ss    (R, N_y, W) words: the setup runs one block per (round j, tile
//         of 32 rows y), the la rows of its tile staged in shared memory
//         and the fd rows of round j-1 passed through a second tile 32
//         rows at a time; one warp per row y and one lane per witness w
//         count la >= fd with 16-byte loads, and the warp packs its 32
//         verdicts with __ballot_sync (lane 0 stores the word);
//   votes (R, N_x, W) words, transposed as pack_votes_t lays them out:
//         the same block packs the d = 1 votes of round j-1 whose voters
//         are its 32 rows y, one word per witness x;
// then one block per round i votes with the whole round in shared memory
// (the votes and the next step's, the voting round's ss words, W / N x 4
// = 1/8 of the wide scratch's bytes at N = 256):
//   yays[y, x] = sum_w popc(ss[j, y, w] & vT[x, w]), total[y] = the ss
//   row's popcount; the step's verdicts are packed by ballot over 32
//   voters y into the next vote words, a coin step taking the voter's
//   wide coin bit where not strong.
// The early per-round exit is the wide kernel's. Zero padding bits add
// nothing to any popcount, so every integer equals the wide layout's.
// Past 736 validators the vote's words (and past 860 the setup's two
// tiles) no longer fit one block's shared memory: that launch then stages
// them in its block's slice of a device scratch (common.cuh
// babble_staging), the same code reading them through L1/L2.
//
// babble_fame_setup launches the setup alone, in either layout, for the
// device mesh (babble_tpu/tpu/sharded.py:384, kernels._fame_setup run
// replicated before the rounds-sharded vote): wide ss (R, N, N) and votes0
// (R, N, N) uint8, or packed ss (R, N, W) and votes0 (R, N_x, W) words.

#include "common.cuh"

#define DF_THREADS 1024
#define DF_WARPS (DF_THREADS / 32)

__global__ void fame_setup(const int32_t* __restrict__ wtable,
                           const int32_t* __restrict__ la,
                           const int32_t* __restrict__ fd,
                           const int32_t* __restrict__ index,
                           uint8_t* ss, uint8_t* votes, long long votes_stride,
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

    // votes0[j, y, x = w]: round j's first (N, N) plane, votes_stride
    // elements apart (buffer 0 of the vote's ping-pong pair)
    uint8_t v = 0;
    if (j + 1 < r_max) {
        int wn = wtable[(long long)(j + 1) * n + y];
        if (wn >= 0) {
            int rx = babble_clamp(wtable[(long long)j * n + w], 0, e - 1);
            v = la[(long long)babble_clamp(wn, 0, e - 1) * n + w] >= index[rx];
        }
    }
    votes[(long long)j * votes_stride + (long long)y * n + w] = v;
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


// the packed setup: grid (r_max, words), one block per (round j, y tile)
template <bool DEV>
__global__ void __launch_bounds__(DF_THREADS)
fame_setup_packed(const int32_t* __restrict__ wtable,
                  const int32_t* __restrict__ la,
                  const int32_t* __restrict__ fd,
                  const int32_t* __restrict__ index,
                  uint32_t* ss, uint32_t* vt0,
                  int r_max, int n, int e, int words, int super_majority,
                  int32_t* stage, long long stage_words) {
    int32_t* smem = babble_staging<DEV>(stage, stage_words);
    const int ld = babble_tile_ld(n);
    int32_t* tile_a = smem;              // (32, ld) la rows of round j, this y tile
    int32_t* tile_b = tile_a + 32 * ld;  // (32, ld) fd rows of round j - 1, a w tile
    int32_t* wv_j = tile_b + 32 * ld;    // (n,) witness present in round j
    int32_t* wv_p = wv_j + n;            // ... in round j - 1
    int32_t* idx_p = wv_p + n;           // (n,) index of round j - 1's witness rows
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int j = blockIdx.x;
    const int yt = blockIdx.y;
    const int y = yt * 32 + warp;
    const int32_t* wt_j = wtable + (long long)j * n;
    const int32_t* wt_p = wtable + (long long)(j - 1) * n;

    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        wv_j[x] = wt_j[x] >= 0;
        wv_p[x] = j > 0 && wt_p[x] >= 0;
        // an absent witness reads row 0, as the reference's gather clamps
        idx_p[x] = j > 0 ? index[babble_clamp(wt_p[x], 0, e - 1)] : 0;
    }
    babble_stage_tile(tile_a, ld, n, BABBLE_MIN_INT32, [&](int r) {
        const int yy = yt * 32 + r;
        return yy < n ? la + (long long)babble_clamp(wt_j[yy], 0, e - 1) * n : nullptr;
    });
    __syncthreads();
    const int any_y = __syncthreads_or(j > 0 && y < n && wv_j[y]);

    // ss words: word wt of row y holds witnesses w = 32 wt + lane
    for (int wt = 0; wt < words; ++wt) {
        const int w = wt * 32 + lane;
        const int go = any_y && __syncthreads_or(w < n && wv_p[w]);
        int s = 0;
        if (go) {
            babble_stage_tile(tile_b, ld, n, BABBLE_MAX_INT32, [&](int r) {
                const int ww = wt * 32 + r;
                return ww < n ? fd + (long long)babble_clamp(wt_p[ww], 0, e - 1) * n : nullptr;
            });
            __syncthreads();
            if (y < n && w < n && wv_j[y] && wv_p[w]) {
                s = babble_tile_count_ge(tile_a + warp * ld, tile_b + lane * ld, ld)
                    >= super_majority;
            }
        }
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, s);
        if (lane == 0 && y < n) ss[((long long)j * n + y) * words + wt] = bits;
        __syncthreads();  // tile_b is restaged next
    }

    // the d = 1 votes of round i = j - 1, voters y of round j: word yt of
    // witness x's column. Round R - 1 has no voters above it: block j = 0
    // zeroes its words.
    const int yv = yt * 32 + lane;
    const int i = j > 0 ? j - 1 : r_max - 1;
    for (int x = warp; x < n; x += DF_WARPS) {
        int v = 0;
        if (j > 0 && yv < n && wv_j[yv]) v = tile_a[lane * ld + x] >= idx_p[x];
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, v);
        if (lane == 0) vt0[((long long)i * n + x) * words + yt] = bits;
    }
}

// the packed vote: one block per round i, the round's words in shared memory
template <bool DEV>
__global__ void __launch_bounds__(DF_THREADS)
fame_vote_packed(const int32_t* __restrict__ wtable,
                 const uint8_t* __restrict__ coin_bit,
                 const int32_t* __restrict__ last_round,
                 const uint32_t* __restrict__ ss, const uint32_t* __restrict__ vt0,
                 uint8_t* decided, uint8_t* famous, uint8_t* rounds_decided,
                 int r_max, int n, int e, int words, int super_majority,
                 int n_participants, int d_cap, int32_t* stage, long long stage_words) {
    int32_t* smem = babble_staging<DEV>(stage, stage_words);
    const int nw = n * words;
    const int ldw = words | 1;  // odd row stride: lanes over rows y hit distinct banks
    uint32_t* vt = (uint32_t*)smem;    // (n, words) vote words of round i
    uint32_t* vt_next = vt + nw;
    uint32_t* ss_s = vt_next + nw;     // (n, ldw) ss words of the voting round
    int32_t* tot = (int32_t*)(ss_s + n * ldw);  // (n,) popcount of each ss row
    int32_t* vy = tot + n;             // (n,) voter y present and j <= last_round
    int32_t* coin = vy + n;            // (n,) voter y's coin bit
    int32_t* wv = coin + n;            // wvalid[i, x]
    int32_t* dec = wv + n;             // decided[i, x]
    int32_t* fam = dec + n;            // famous[i, x]
    int32_t* any_dec = fam + n;        // this step's decisions
    int32_t* any_fam = any_dec + n;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int i = blockIdx.x;
    const int lr = *last_round;
    for (int k = threadIdx.x; k < nw; k += blockDim.x) vt[k] = vt0[(long long)i * nw + k];
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        wv[x] = wtable[(long long)i * n + x] >= 0;
        dec[x] = fam[x] = any_dec[x] = any_fam[x] = 0;
    }
    __syncthreads();

    for (int d = 2;; ++d) {
        int act = 0;
        if (i + d <= lr) {
            for (int x = threadIdx.x; x < n; x += blockDim.x) act |= wv[x] && !dec[x];
        }
        if (!__syncthreads_or(act) || d > d_cap) break;

        const int j = i + d;
        const bool j_ok = j <= lr;
        const int jc = babble_clamp(j, 0, r_max - 1);
        for (int k = threadIdx.x; k < nw; k += blockDim.x) {
            ss_s[(k / words) * ldw + k % words] = j_ok ? ss[(long long)jc * nw + k] : 0u;
        }
        for (int yy = threadIdx.x; yy < n; yy += blockDim.x) {
            const int wy = wtable[(long long)jc * n + yy];
            vy[yy] = j_ok && wy >= 0;
            coin[yy] = coin_bit[babble_clamp(wy, 0, e - 1)];
        }
        __syncthreads();
        for (int yy = threadIdx.x; yy < n; yy += blockDim.x) {
            int t = 0;
            for (int k = 0; k < words; ++k) t += __popc(ss_s[yy * ldw + k]);
            tot[yy] = t;
        }
        __syncthreads();

        const bool is_coin = (d % n_participants) == 0;
        for (int task = warp; task < nw; task += DF_WARPS) {
            const int x = task / words, wd = task % words;
            const int y = wd * 32 + lane;
            int nv = 0, dn = 0, dv = 0;
            if (y < n) {
                int yays = 0;
                for (int k = 0; k < words; ++k) yays += __popc(ss_s[y * ldw + k] & vt[x * words + k]);
                const int nays = tot[y] - yays;
                const int v = yays >= nays;
                const bool strong = (v ? yays : nays) >= super_majority;
                if (is_coin) {
                    nv = strong ? v : coin[y];
                } else {
                    nv = v;
                    dn = strong && vy[y] && wv[x] && !dec[x];
                    dv = dn && v;
                }
            }
            const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, nv);
            const unsigned b_dn = __ballot_sync(BABBLE_FULL_MASK, dn);
            const unsigned b_dv = __ballot_sync(BABBLE_FULL_MASK, dv);
            if (lane == 0) {
                vt_next[task] = bits;
                // benign races: every writer stores 1
                if (b_dn) any_dec[x] = 1;
                if (b_dv) any_fam[x] = 1;
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
        for (int k = threadIdx.x; k < nw; k += blockDim.x) vt[k] = vt_next[k];
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
    void* ss, void* votes, uint8_t* decided, uint8_t* famous,
    uint8_t* rounds_decided, int32_t* stage_setup, int32_t* stage_vote, int r_max, int n,
    int e, int super_majority,
    int n_participants, int d_cap, int packed, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (packed) {
        // ss (r_max, n, words) and votes (r_max, n, words) uint32 words;
        // a launch handed a scratch stages in it (tpu/_ext.py staging
        // chooses the form per launch), else in shared memory
        const int words = (n + 31) / 32;
        const size_t smem_setup =
            ((size_t)64 * babble_tile_ld(n) + (size_t)3 * n) * sizeof(int32_t);
        const dim3 grid_setup(r_max, words);
        if (stage_setup != nullptr) {
            fame_setup_packed<true><<<grid_setup, DF_THREADS, 0, s>>>(
                wtable, la, fd, index, (uint32_t*)ss, (uint32_t*)votes, r_max, n, e,
                words, super_majority, stage_setup, babble_stage_words(smem_setup));
        } else {
            BABBLE_CHECK(babble_allow_smem(fame_setup_packed<false>, smem_setup));
            fame_setup_packed<false><<<grid_setup, DF_THREADS, smem_setup, s>>>(
                wtable, la, fd, index, (uint32_t*)ss, (uint32_t*)votes, r_max, n, e,
                words, super_majority, nullptr, 0);
        }
        BABBLE_CHECK_LAUNCH();
        const size_t smem_vote =
            ((size_t)2 * n * words + (size_t)n * (words | 1) + (size_t)8 * n) * sizeof(int32_t);
        if (stage_vote != nullptr) {
            fame_vote_packed<true><<<r_max, DF_THREADS, 0, s>>>(
                wtable, coin_bit, last_round, (const uint32_t*)ss, (const uint32_t*)votes,
                decided, famous, rounds_decided, r_max, n, e, words, super_majority,
                n_participants, d_cap, stage_vote, babble_stage_words(smem_vote));
        } else {
            BABBLE_CHECK(babble_allow_smem(fame_vote_packed<false>, smem_vote));
            fame_vote_packed<false><<<r_max, DF_THREADS, smem_vote, s>>>(
                wtable, coin_bit, last_round, (const uint32_t*)ss, (const uint32_t*)votes,
                decided, famous, rounds_decided, r_max, n, e, words, super_majority,
                n_participants, d_cap, nullptr, 0);
        }
        BABBLE_CHECK_LAUNCH();
        return 0;
    }
    uint8_t* ss8 = (uint8_t*)ss;
    uint8_t* votes8 = (uint8_t*)votes;
    long long cells = (long long)r_max * n * n;
    fame_setup<<<babble_blocks(cells, 256), 256, 0, s>>>(
        wtable, la, fd, index, ss8, votes8, 2 * (long long)n * n, r_max, n, e,
        super_majority);
    BABBLE_CHECK_LAUNCH();
    size_t smem = (size_t)6 * n * sizeof(int32_t);
    BABBLE_CHECK(babble_allow_smem(fame_vote, smem));
    fame_vote<<<r_max, 256, smem, s>>>(
        wtable, coin_bit, last_round, ss8, votes8, decided, famous, rounds_decided,
        r_max, n, e, super_majority, n_participants, d_cap);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

extern "C" int babble_fame_setup(
    const int32_t* wtable, const int32_t* la, const int32_t* fd, const int32_t* index,
    void* ss, void* votes, int32_t* stage_setup, int r_max, int n, int e,
    int super_majority, int packed, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (packed) {
        const int words = (n + 31) / 32;
        const size_t smem_setup =
            ((size_t)64 * babble_tile_ld(n) + (size_t)3 * n) * sizeof(int32_t);
        const dim3 grid_setup(r_max, words);
        if (stage_setup != nullptr) {
            fame_setup_packed<true><<<grid_setup, DF_THREADS, 0, s>>>(
                wtable, la, fd, index, (uint32_t*)ss, (uint32_t*)votes, r_max, n, e,
                words, super_majority, stage_setup, babble_stage_words(smem_setup));
        } else {
            BABBLE_CHECK(babble_allow_smem(fame_setup_packed<false>, smem_setup));
            fame_setup_packed<false><<<grid_setup, DF_THREADS, smem_setup, s>>>(
                wtable, la, fd, index, (uint32_t*)ss, (uint32_t*)votes, r_max, n, e,
                words, super_majority, nullptr, 0);
        }
        BABBLE_CHECK_LAUNCH();
        return 0;
    }
    const long long cells = (long long)r_max * n * n;
    fame_setup<<<babble_blocks(cells, 256), 256, 0, s>>>(
        wtable, la, fd, index, (uint8_t*)ss, (uint8_t*)votes, (long long)n * n, r_max, n,
        e, super_majority);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
