// shard_fame: one voting step of the mesh's fame loop on one position's shard.
//
// Replaces babble_tpu/tpu/sharded.py:149 local_fame (the body of
// _fame_loop_fn's step and chunk_body), in both voting-table layouts. A
// position holds B rounds (rows i_rows) of the j-aligned voting state:
//   ss_s   wide (B, N_y, N_w) uint8, the witness columns w of its validator
//          shard; packed (B, N_y, W_l) uint32 words of those columns
//   votes  wide (B, N_w, N_x) uint8, the rows w of its shard; packed
//          (B, N_x, W_l) uint32 words, transposed (pack_votes_t)
//   wv_s, coin_s (B, N_y) uint8; wvalid, decided, famous (B, N_x) uint8.
// Three launches, with the mesh's collectives between them:
//   (a) tally:  yays[b, y, x] = sum_w ss_s[b, y, w] * votes[b, w, x]
//               (packed: sum_k popc(ss_s[b, y, k] & votes[b, x, k])),
//               total[b, y] = sum_w ss_s[b, y, w], both 0 where the voting
//               round j = i_rows[b] + d lies past last_round; integer loops,
//               no float product. On a 2-D mesh the caller sums both over
//               the validator axis (psum) before (b).
//   (b) decide: v = yays >= total - yays, strong = max(yays, nays) >= sm;
//               on a non-coin step (d % n_participants != 0) the first
//               strong verdict of a valid voter decides an undecided valid
//               witness x (famous = any such verdict is yes); the next votes
//               are v, or on a coin step v where strong else the voter's
//               coin bit. Each position writes only its shard's slice of
//               them: rows [v_off, v_off + v_len) of the voters (wide), or
//               words [v_off, v_off + v_len) packed by __ballot_sync over 32
//               voters, as decide_fame's packed vote packs them.
//   (c) active: whether any valid undecided witness of the shard still has
//               a voting round: i_rows[b] + d0 <= last_round; one int the
//               host reads once per chunk.
// The ring shift of ss_s, wv_s and coin_s between steps is a copy on the
// mesh (tpu/mesh.py).
//
// Bound: bytes at the mesh's shapes (the votes, the ss rows of the rounds
// still voting and the (B, N_y, N_x) tallies, each read or written once);
// the tally's operations are N^3 per voting round, far below the card's
// integer rate once rounds past last_round are skipped.

#include "common.cuh"

#define SF_THREADS 256
#define SF_WARPS (SF_THREADS / 32)

// one block per (round b, voter y), threads over the witnesses x
template <bool PACKED>
__global__ void __launch_bounds__(SF_THREADS)
sf_tally(const void* __restrict__ ss, const void* __restrict__ votes,
         const int32_t* __restrict__ i_rows, const int32_t* __restrict__ last_round,
         int32_t* yays, int32_t* total, int ny, int nw, int nx, int d) {
    extern __shared__ uint32_t row[];  // (nw,) the ss row: 0/1 (wide) or words
    __shared__ int s_total;
    const int b = blockIdx.x, y = blockIdx.y;
    const bool j_ok = i_rows[b] + d <= *last_round;
    const long long r0 = ((long long)b * ny + y) * nw;
    if (threadIdx.x == 0) s_total = 0;
    __syncthreads();
    int cnt = 0;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
        uint32_t s = 0;
        if (j_ok) s = PACKED ? ((const uint32_t*)ss)[r0 + w] : ((const uint8_t*)ss)[r0 + w];
        row[w] = s;
        cnt += PACKED ? __popc(s) : (int)s;
    }
    if (cnt) atomicAdd(&s_total, cnt);
    __syncthreads();
    if (threadIdx.x == 0) total[(long long)b * ny + y] = s_total;
    int32_t* out = yays + ((long long)b * ny + y) * nx;
    for (int x = threadIdx.x; x < nx; x += blockDim.x) {
        int ya = 0;
        if (j_ok && s_total) {
            if (PACKED) {
                const uint32_t* vt = (const uint32_t*)votes + ((long long)b * nx + x) * nw;
                for (int k = 0; k < nw; ++k) ya += __popc(row[k] & vt[k]);
            } else {
                const uint8_t* vb = (const uint8_t*)votes + (long long)b * nw * nx + x;
                for (int w = 0; w < nw; ++w) {
                    if (row[w]) ya += vb[(long long)w * nx];
                }
            }
        }
        out[x] = ya;
    }
}

// one warp per (round b, witness x), lanes over the voters y in words of 32
template <bool PACKED>
__global__ void __launch_bounds__(SF_THREADS)
sf_decide(const int32_t* __restrict__ yays, const int32_t* __restrict__ total,
          const int32_t* __restrict__ i_rows, const int32_t* __restrict__ last_round,
          const uint8_t* __restrict__ wvalid, uint8_t* decided, uint8_t* famous,
          const uint8_t* __restrict__ wv_s, const uint8_t* __restrict__ coin_s,
          void* votes, int ny, int nx, int v_off, int v_len, int d,
          int n_participants, int super_majority) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x;
    const int x = blockIdx.y * SF_WARPS + (threadIdx.x >> 5);
    if (x >= nx) return;  // warp-uniform; no block barrier follows
    const bool j_ok = i_rows[b] + d <= *last_round;
    const bool is_coin = (d % n_participants) == 0;
    const long long bx = (long long)b * nx + x;
    const bool open = wvalid[bx] && !decided[bx];
    bool any_dec = false, any_fam = false;
    for (int y0 = 0; y0 < ny; y0 += 32) {
        const int y = y0 + lane;
        int nv = 0, dn = 0, dv = 0;
        if (y < ny) {
            const long long by = (long long)b * ny + y;
            const int ya = yays[by * nx + x];
            const int na = total[by] - ya;
            const int v = ya >= na;
            const bool strong = (v ? ya : na) >= super_majority;
            if (is_coin) {
                nv = strong ? v : coin_s[by];
            } else {
                nv = v;
                dn = strong && j_ok && wv_s[by] && open;
                dv = dn && v;
            }
        }
        const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, nv);
        any_dec |= __ballot_sync(BABBLE_FULL_MASK, dn) != 0;
        any_fam |= __ballot_sync(BABBLE_FULL_MASK, dv) != 0;
        if (PACKED) {
            const int k = y0 >> 5;
            if (lane == 0 && k >= v_off && k < v_off + v_len) {
                ((uint32_t*)votes)[bx * v_len + (k - v_off)] = bits;
            }
        } else if (y < ny && y >= v_off && y < v_off + v_len) {
            ((uint8_t*)votes)[((long long)b * v_len + (y - v_off)) * nx + x] = (uint8_t)nv;
        }
    }
    if (lane == 0 && any_dec) {
        famous[bx] = any_fam;
        decided[bx] = 1;
    }
}

// one block over the shard: any valid undecided witness with a voting
// round left at offset d0
__global__ void sf_active(const uint8_t* __restrict__ wvalid,
                          const uint8_t* __restrict__ decided,
                          const int32_t* __restrict__ i_rows,
                          const int32_t* __restrict__ last_round, int32_t* flag,
                          int b_rows, int nx, int d0) {
    const int lr = *last_round;
    int act = 0;
    const long long cells = (long long)b_rows * nx;
    for (long long k = threadIdx.x; k < cells; k += blockDim.x) {
        act |= wvalid[k] && !decided[k] && i_rows[k / nx] + d0 <= lr;
    }
    act = __syncthreads_or(act);
    if (threadIdx.x == 0) *flag = act;
}

extern "C" int babble_shard_fame_tally(
    const void* ss, const void* votes, const int32_t* i_rows, const int32_t* last_round,
    int32_t* yays, int32_t* total, int b_rows, int ny, int nw, int nx, int d, int packed,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(b_rows, ny);
    const size_t smem = (size_t)(nw > 0 ? nw : 1) * sizeof(uint32_t);
    if (packed) {
        BABBLE_CHECK(babble_allow_smem(sf_tally<true>, smem));
        sf_tally<true><<<grid, SF_THREADS, smem, s>>>(ss, votes, i_rows, last_round, yays,
                                                      total, ny, nw, nx, d);
    } else {
        BABBLE_CHECK(babble_allow_smem(sf_tally<false>, smem));
        sf_tally<false><<<grid, SF_THREADS, smem, s>>>(ss, votes, i_rows, last_round, yays,
                                                       total, ny, nw, nx, d);
    }
    BABBLE_CHECK_LAUNCH();
    return 0;
}

extern "C" int babble_shard_fame_decide(
    const int32_t* yays, const int32_t* total, const int32_t* i_rows,
    const int32_t* last_round, const uint8_t* wvalid, uint8_t* decided, uint8_t* famous,
    const uint8_t* wv_s, const uint8_t* coin_s, void* votes, int b_rows, int ny, int nx,
    int v_off, int v_len, int d, int n_participants, int super_majority, int packed,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(b_rows, (nx + SF_WARPS - 1) / SF_WARPS);
    if (packed) {
        sf_decide<true><<<grid, SF_THREADS, 0, s>>>(
            yays, total, i_rows, last_round, wvalid, decided, famous, wv_s, coin_s, votes,
            ny, nx, v_off, v_len, d, n_participants, super_majority);
    } else {
        sf_decide<false><<<grid, SF_THREADS, 0, s>>>(
            yays, total, i_rows, last_round, wvalid, decided, famous, wv_s, coin_s, votes,
            ny, nx, v_off, v_len, d, n_participants, super_majority);
    }
    BABBLE_CHECK_LAUNCH();
    return 0;
}

extern "C" int babble_shard_fame_active(
    const uint8_t* wvalid, const uint8_t* decided, const int32_t* i_rows,
    const int32_t* last_round, int32_t* flag, int b_rows, int nx, int d0,
    int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    sf_active<<<1, 1024, 0, s>>>(wvalid, decided, i_rows, last_round, flag, b_rows, nx, d0);
    BABBLE_CHECK_LAUNCH();
    return 0;
}
