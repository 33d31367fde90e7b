// decide_fame: Hashgraph virtual voting over the witness table.
//
// Replaces babble_tpu/tpu/kernels.py:335 _decide_fame (_fame_setup_tables
// and the while_loop of _decide_fame_tables), in both voting-table
// layouts, with one pair of launches: the two layouts give equal integers,
// and both tables are this call's own scratch, so the wide call votes on
// bit words too.
//
// Setup, a block per (round j, tile of 64 voters y, tile of 64 witnesses
// w): the compare-count tile (common.cuh babble_count_ge_tile, as
// decide_window's setup takes it: the coordinates through shared memory by
// cp.async, a 4 x 4 register tile of (y, w) pairs per thread) counts la >=
// fd, the same shared memory at every width:
//   ss[j, y, w]  = y (round j) strongly sees w (round j - 1): the count
//                  reaches super_majority (no round -1: masked), packed by
//                  __ballot_sync into word w / 32 of row y;
//   aux[j, y]    = the row's popcount * 4 + y's coin bit * 2 + y present
//                  (total[y] counted once per plane; each witness tile adds
//                  its words' popcounts into the zeroed row);
//   vt0[i, x, :] = the d = 1 votes of round i = j - 1 whose voters are the
//                  tile's rows, columns x the witness tile: la[y][x] >=
//                  index[x] (transposed, as pack_votes_t lays them out).
// Vote, grid (tile of FV_COLS columns x, round i), fame_vote.cuh's
// fame_task: a warp per column, its votes in registers (in shared memory
// past 1,024 validators), steps to the
// column's own exit, the strongly-see planes of rounds i + 2, i + 3, ...
// fetched ahead into a shared-memory ring. The last block of round i to
// finish (a ticket per round, zeroed by the setup) writes rounds_decided[i]
// from the flags every tile of the round has or-ed in.
//
// Bound: bytes at small widths (the witness rows of la and fd, R * N * N
// int32 each, and the (R, N) outputs), the setup's N^3 compares a round
// from a few hundred validators; the tally is N^2 words popcounts per round
// and step. The setup takes the same shared memory at every width; the
// vote the same up to 1,024 validators, then a ring of fewer slots beside
// the columns' words (fame_vote.cuh fv_stages), up to 19,296 validators
// (603 words). No staging form.
//
// babble_fame_setup launches the setup alone, in either layout, for the
// device mesh (babble_tpu/tpu/sharded.py:384, kernels._fame_setup run
// replicated before the rounds-sharded vote): packed ss (R, N, W) and
// votes0 (R, N_x, W) words, or the wide (R, N, N) uint8 tables, which the
// same tiles write a byte a verdict.

#include "fame_vote.cuh"

// The setup: a block per (round j, tile of FS_T voters y, tile of FS_T
// witnesses w), FS_THREADS threads, each a FS_TM x FS_TN register tile of
// (y, w) pairs of the compare-count tile (common.cuh babble_count_ge_tile:
// la rows y of round j against fd rows w of round j - 1, the coordinates
// through shared memory by cp.async), the same shared memory at every
// width.
#define FS_T 64
#define FS_THREADS 256
#define FS_STAGES 3
#define FS_TM 4
#define FS_TN 4

// WIDE writes the mesh's byte tables: ss (R, N, N), votes (R, N_y, N_x).
// Packed: ss (R, ss_rows, ss_ld) words (rows past n zero), votes (R, N_x,
// W) words. Where aux is not null (K3) the block adds its words' popcounts
// * 4 into aux (R, ss_rows), which the launcher zeroes, and the blocks of
// the first witness tile the voter's coin bit * 2 + present; flags (R, 2)
// is zeroed, and rounds past *last_round are left unwritten: K3's vote reads
// no plane past last_round, nor the d = 1 votes of a round with no step.
template <bool WIDE>
__global__ void __launch_bounds__(FS_THREADS)
fame_setup_pairs(const int32_t* __restrict__ wtable, const int32_t* __restrict__ la,
                 const int32_t* __restrict__ fd, const int32_t* __restrict__ index,
                 const uint8_t* __restrict__ coin_bit, const int32_t* __restrict__ last_round,
                 void* ss, void* votes, int32_t* aux, uint32_t* flags, int ss_rows, int ss_ld,
                 int r_max, int n, int e, int words, int super_majority) {
    extern __shared__ int4 fs_smem4[];
    int32_t* smem = reinterpret_cast<int32_t*>(fs_smem4);
    __shared__ const int32_t* a_rows[FS_T];  // la rows y of round j (present, j > 0)
    __shared__ const int32_t* b_rows[FS_T];  // fd rows w of round j - 1 (present)
    __shared__ int idx_x[FS_T];              // index of round j - 1's witness x
    constexpr int TX = FS_T / FS_TN, TY = FS_T / FS_TM;
    constexpr int FLD = FS_T + 1;  // the verdict tiles' row stride
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int N_WARPS = FS_THREADS / 32;
    const int n_t = (n + FS_T - 1) / FS_T;
    const int j = blockIdx.y;
    const int y0 = (blockIdx.x / n_t) * FS_T, w0 = (blockIdx.x % n_t) * FS_T;

    if (flags != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        flags[2 * j] = 0;
        flags[2 * j + 1] = 0;
    }
    if (last_round != nullptr && j > *last_round) return;
    int has_a = 0, has_b = 0;
    if (threadIdx.x < FS_T) {
        const int t = threadIdx.x, y = y0 + t, w = w0 + t;
        const int ry = y < n ? wtable[(long long)j * n + y] : -1;
        const int rw = j > 0 && w < n ? wtable[(long long)(j - 1) * n + w] : -1;
        // an absent witness reads row 0, as the reference's gather clamps
        const long long cy = babble_clamp(ry, 0, e - 1), cw = babble_clamp(rw, 0, e - 1);
        a_rows[t] = j > 0 && ry >= 0 ? la + cy * n : nullptr;
        b_rows[t] = rw >= 0 ? fd + cw * n : nullptr;
        idx_x[t] = j > 0 ? index[cw] : 0;
        has_a = a_rows[t] != nullptr;
        has_b = rw >= 0;
        if (!WIDE && aux != nullptr && w0 == 0 && y < n) {
            atomicAdd(aux + (long long)j * ss_rows + y, (coin_bit[cy] ? 2 : 0) + (ry >= 0 ? 1 : 0));
        }
    }
    // count only where the tile holds a present pair
    const int any_a = __syncthreads_or(has_a);
    const int any_b = __syncthreads_or(has_b);
    const bool go = any_a && any_b;
    int* flg = smem;  // (FS_T, FLD) verdicts; the tile's ring before
    if (go) {
        int cnt[FS_TM][FS_TN];
        babble_count_ge_tile<FS_T, FS_T, FS_TM, FS_TN, FS_STAGES>(
            smem, n, a_rows, b_rows,
            babble_rows_aligned16(la, n) && babble_rows_aligned16(fd, n), cnt);
        const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
        for (int i = 0; i < FS_TM; ++i)
#pragma unroll
            for (int q = 0; q < FS_TN; ++q) {
                const int m = ty + i * TY, w = tx + q * TX;
                flg[m * FLD + w] = a_rows[m] != nullptr && b_rows[w] != nullptr
                                   && cnt[i][q] >= super_majority;
            }
        __syncthreads();
    }
    if (WIDE) {
        // ss bytes, a row of the tile per warp and step, lanes over w
        for (int m = warp; m < FS_T; m += N_WARPS) {
            const int y = y0 + m;
            if (y >= n) continue;
            uint8_t* out = (uint8_t*)ss + ((long long)j * n + y) * n;
            for (int wl = lane; wl < FS_T; wl += 32) {
                if (w0 + wl < n) out[w0 + wl] = go ? (uint8_t)flg[m * FLD + wl] : (uint8_t)0;
            }
        }
    } else {
        // ss row bits: word (w0 / 32 + h) of row y holds witnesses w0 + 32 h + lane
        for (int k = warp; k < FS_T * (FS_T / 32); k += N_WARPS) {
            const int m = k / (FS_T / 32), h = k % (FS_T / 32);
            const int y = y0 + m, wd = w0 / 32 + h;
            const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, go && flg[m * FLD + 32 * h + lane]);
            if (lane == 0 && y < ss_rows && wd < words) {
                ((uint32_t*)ss)[((long long)j * ss_rows + y) * ss_ld + wd] = bits;
                if (aux != nullptr && bits) atomicAdd(aux + (long long)j * ss_rows + y, 4 * __popc(bits));
            }
        }
    }
    __syncthreads();  // flg is rewritten next
    // the d = 1 votes of round i = j - 1, voters y of round j, columns x of
    // the witness tile: la[y][x] >= index[x]. Round R - 1 has no voters
    // above it: the blocks of j = 0 zero its entries.
    const int i = j > 0 ? j - 1 : r_max - 1;
    constexpr int PER = FS_T * FS_T / FS_THREADS;  // every load in flight at once
    int v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int k = threadIdx.x + u * FS_THREADS;
        const int m = k / FS_T, xl = k % FS_T;
        v[u] = 0;
        if (a_rows[m] != nullptr && w0 + xl < n) v[u] = a_rows[m][w0 + xl] >= idx_x[xl];
    }
    if (WIDE) {
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int k = threadIdx.x + u * FS_THREADS;
            const int y = y0 + k / FS_T, x = w0 + k % FS_T;
            if (y < n && x < n) ((uint8_t*)votes)[((long long)i * n + y) * n + x] = (uint8_t)v[u];
        }
        return;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int k = threadIdx.x + u * FS_THREADS;
        flg[(k / FS_T) * FLD + k % FS_T] = v[u];
    }
    __syncthreads();
    // word (y0 / 32 + h) of column x holds voters y0 + 32 h + lane
    for (int k = warp; k < FS_T * (FS_T / 32); k += N_WARPS) {
        const int xl = k / (FS_T / 32), h = k % (FS_T / 32);
        const int wd = y0 / 32 + h;
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, flg[(32 * h + lane) * FLD + xl]);
        if (lane == 0 && w0 + xl < n && wd < words) {
            ((uint32_t*)votes)[((long long)i * n + w0 + xl) * words + wd] = bits;
        }
    }
}

// K3's voting tables and outputs, as fame_task reads and writes them
struct K3Src {
    const int32_t* wtable;  // (R, N)
    const uint32_t* vt0;    // (R, N_x, W)
    uint8_t* decided;
    uint8_t* famous;
    int n_cols, r_max, words;
    __device__ __forceinline__ bool valid(int i, int x) const {
        return wtable[(long long)i * n_cols + x] >= 0;
    }
    // the voters of step d lie in round i + d, clamped as the reference's
    // gather clamps (a round past r_max - 1 is never reached by a caller
    // whose last_round fits the table)
    __device__ __forceinline__ int plane(int i, int d) const { return min(i + d, r_max - 1); }
    __device__ __forceinline__ uint32_t col0(int i, int x, int k) const {
        return vt0[((long long)i * n_cols + x) * words + k];
    }
    __device__ __forceinline__ void done(int i, int x, bool dec, bool fam) const {
        decided[(long long)i * n_cols + x] = dec;
        famous[(long long)i * n_cols + x] = fam;
    }
};

// The vote: grid (tiles of FV_COLS columns, r_max)
template <int WMAX>
__global__ void __launch_bounds__(FV_THREADS)
fame_vote(const K3Src src, const FameTables t, const int32_t* __restrict__ last_round,
          uint32_t* flags, uint8_t* rounds_decided, int d_cap, int n_participants,
          int super_majority) {
    extern __shared__ __align__(16) unsigned char fv_smem[];
    const int i = blockIdx.y;
    const int d_end = min(*last_round - i, d_cap);
    const FvColumn c = fame_task<WMAX>(src, t, i, blockIdx.x * FV_COLS, d_end, n_participants,
                                       super_majority, fv_smem);
    const bool lead = (threadIdx.x & 31) == 0;
    const int open = __syncthreads_or(lead && c.valid && !c.decided);
    const int present = __syncthreads_or(lead && c.valid);
    if (threadIdx.x == 0) {
        const unsigned f = (open ? 1u : 0u) | (present ? 2u : 0u);
        if (f) atomicOr(flags + 2 * i, f);
        __threadfence();
        if (atomicAdd(flags + 2 * i + 1, 1u) == gridDim.x - 1) {
            __threadfence();
            const unsigned all = atomicOr(flags + 2 * i, 0u);
            rounds_decided[i] = !(all & 1u) && (all & 2u);
        }
    }
}

static inline size_t df_setup_smem() {
    return (size_t)babble_count_tile_words<FS_T, FS_T, FS_STAGES>() * sizeof(int32_t);
}

template <bool WIDE>
static int df_setup(const int32_t* wtable, const int32_t* la, const int32_t* fd,
                    const int32_t* index, const uint8_t* coin_bit,
                    const int32_t* last_round, void* ss, void* votes, int32_t* aux,
                    uint32_t* flags, int ss_rows, int ss_ld, int r_max, int n, int e,
                    int super_majority, cudaStream_t s) {
    const int words = (n + 31) / 32;
    const int n_t = (n + FS_T - 1) / FS_T;
    const size_t smem = df_setup_smem();
    if (aux != nullptr) {
        BABBLE_CHECK(cudaMemsetAsync(aux, 0, (size_t)r_max * ss_rows * sizeof(int32_t), s));
    }
    BABBLE_CHECK(babble_allow_smem(fame_setup_pairs<WIDE>, smem));
    fame_setup_pairs<WIDE><<<dim3(n_t * n_t, r_max), FS_THREADS, smem, s>>>(
        wtable, la, fd, index, coin_bit, last_round, ss, votes, aux, flags, ss_rows, ss_ld,
        r_max, n, e, words, super_majority);
    BABBLE_CHECK_LAUNCH();
    return 0;
}

// Scratch (tpu/_ext.py decide_fame allocates it): ss (R, 32 W, W | 1) and
// aux (R, 32 W) int32, vt0 (R, N, W) words, flags (R, 2); W = ceil(N /
// 32), at most 603 (fv_stages). Both layouts take this launch pair (and
// aux's memset).
extern "C" int babble_decide_fame(
    const int32_t* wtable, const int32_t* la, const int32_t* fd, const int32_t* index,
    const uint8_t* coin_bit, const int32_t* last_round, uint32_t* ss, int32_t* aux,
    uint32_t* vt0, uint32_t* flags, uint8_t* decided, uint8_t* famous,
    uint8_t* rounds_decided, int r_max, int n, int e, int super_majority,
    int n_participants, int d_cap, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int words = (n + 31) / 32;
    if (fv_stages(words) < 2 || r_max < 1 || r_max > 65535) return (int)cudaErrorInvalidValue;
    const FameTables t = fv_tables(ss, aux, words);
    const int err = df_setup<false>(wtable, la, fd, index, coin_bit, last_round, ss, vt0, aux,
                                    flags, t.n_pad, t.ldw, r_max, n, e, super_majority, s);
    if (err) return err;
    const K3Src src{wtable, vt0, decided, famous, n, r_max, words};
    const size_t smem = (size_t)fv_smem_bytes(words);
    const dim3 grid((n + FV_COLS - 1) / FV_COLS, r_max);
    return fv_dispatch(words, [&](auto w) {
        constexpr int WMAX = decltype(w)::value;
        BABBLE_CHECK(babble_allow_smem(fame_vote<WMAX>, smem));
        fame_vote<WMAX><<<grid, FV_THREADS, smem, s>>>(src, t, last_round, flags,
                                                        rounds_decided, d_cap, n_participants,
                                                        super_majority);
        BABBLE_CHECK_LAUNCH();
        return 0;
    });
}

extern "C" int babble_fame_setup(
    const int32_t* wtable, const int32_t* la, const int32_t* fd, const int32_t* index,
    void* ss, void* votes, int r_max, int n, int e, int super_majority, int packed,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int words = (n + 31) / 32;
    if (packed) {
        return df_setup<false>(wtable, la, fd, index, nullptr, nullptr, ss, votes, nullptr,
                               nullptr, n, words, r_max, n, e, super_majority, s);
    }
    return df_setup<true>(wtable, la, fd, index, nullptr, nullptr, ss, votes, nullptr, nullptr,
                          n, n, r_max, n, e, super_majority, s);
}
