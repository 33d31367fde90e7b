// shard_fame: the mesh's fame loop, in one launch where every position
// lies on one card (shard_fame/grid, below), else one voting step of one
// position's shard at a time.
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
// mesh (tpu/mesh.py). These three launches are the form for positions on
// distinct cards (tpu/_ext.py shard_walk_form chooses by layout alone).
//
// Bound: bytes at the mesh's shapes (the votes, the ss rows of the rounds
// still voting and the (B, N_y, N_x) tallies, each read or written once);
// the tally's operations are N^3 per voting round, far below the card's
// integer rate once rounds past last_round are skipped.

#include "fame_vote.cuh"

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

// ---------------------------------------------------------------------------
// shard_fame/grid: the whole fame loop of every position in one cooperative
// launch, where every position lies on one card.
//
// Positions are read through an address table in device memory: (7,
// n_pos) int64, the fields ss_s, votes, wv_s, coin_s, wvalid, decided,
// famous, positions in (rounds index a, validator index v) order; position
// (a, v) holds global rows g = a B .. a B + B - 1 (round i = g). Two phases
// with one grid barrier between them:
//   (1) every position's shards into the vote's tables (fame_vote.cuh
//       FameTables), in the unshifted order of their rows: plane g' holds
//       staged row g' of ss_s, whose words are the validator shards' words
//       (packed) or their bytes packed by __ballot_sync as they are read
//       (wide); aux[g', y] = the popcount of the whole row (the mesh's psum
//       of the totals over the validator axis) * 4 + coin_s * 2 + wv_s; the
//       d = 1 votes of round g into vt (r_pad, N_x, W) words. Only rows g <
//       last_round - 1 vote, and they read planes g' <= last_round - 2, so
//       only those are gathered; the other rows' decided and famous are
//       written 0 here;
//   (2) persistent blocks over the tasks (round g, tile of FV_COLS columns),
//       fame_task as in K3. The ring shift becomes an address offset: at
//       step k = d - 2 row g reads plane (g + k) mod r_pad, the row the
//       per-step form's shifts would have brought to g. The yay tally over
//       every word of the row is the psum over the validator axis. Each
//       column stops at its own exit, i + d > last_round: the per-step
//       loop's own stop (whole chunks, d0 <= r_pad + 2) never comes earlier,
//       since last_round < r_pad, and its steps past a column's exit change
//       nothing (no voter round left: no decision). decided and famous go to
//       every validator position of the row's rounds index; the votes and the
//       shifted state are not written back (sharded_fame returns decided and
//       famous only).
// Bound: bytes, each shard read once (the planes' rows a warp each) and the
// (R, N) outputs written n_v times; the vote's tally as in K3.
// ---------------------------------------------------------------------------

struct ShardSrc {
    const long long* ptrs;  // (7, n_pos)
    const uint32_t* vt;     // (r_pad, N_x, W)
    int n_pos, n_v, b_rows, n_cols, words, r_pad;
    __device__ __forceinline__ const uint8_t* u8(int field, int pos) const {
        return reinterpret_cast<const uint8_t*>(ptrs[(long long)field * n_pos + pos]);
    }
    __device__ __forceinline__ const uint32_t* u32(int field, int pos) const {
        return reinterpret_cast<const uint32_t*>(ptrs[(long long)field * n_pos + pos]);
    }
    __device__ __forceinline__ bool valid(int g, int x) const {
        return u8(4, (g / b_rows) * n_v)[(long long)(g % b_rows) * n_cols + x] != 0;
    }
    __device__ __forceinline__ int plane(int g, int d) const { return (g + d - 2) % r_pad; }
    __device__ __forceinline__ uint32_t col0(int g, int x, int k) const {
        return __ldcg(vt + ((long long)g * n_cols + x) * words + k);
    }
    __device__ __forceinline__ void done(int g, int x, bool dec, bool fam) const {
        const int a = g / b_rows;
        const long long off = (long long)(g % b_rows) * n_cols + x;
        for (int v = 0; v < n_v; ++v) {
            const int p = a * n_v + v;
            reinterpret_cast<uint8_t*>(ptrs[5LL * n_pos + p])[off] = dec;
            reinterpret_cast<uint8_t*>(ptrs[6LL * n_pos + p])[off] = fam;
        }
    }
};

template <int WMAX, bool PACKED>
__global__ void __launch_bounds__(FV_THREADS)
sf_grid(const ShardSrc src, const FameTables t, uint32_t* ss_k, int32_t* aux_k, uint32_t* vt,
        unsigned int* bar, const int32_t* __restrict__ last_round, int ny, int nw_l,
        int n_participants, int super_majority) {
    extern __shared__ __align__(16) unsigned char fv_smem[];
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const int b = src.b_rows, n_v = src.n_v, words = t.words, n_x = src.n_cols;
    const long long cols = (long long)n_v * nw_l;  // witness columns (wide) or words (packed)
    // rows g < g_end vote (g + 2 <= last_round) and read planes g' < g_end
    // only (g' = g + d - 2 <= last_round - 2); the rest decide nothing
    const int lr = *last_round;
    const int g_end = min(src.r_pad, max(lr - 1, 0));

    // (1a) the planes and their aux words, a warp per staged row (g', y)
    for (long long it = warp; it < (long long)g_end * t.n_pad; it += warps) {
        const int g = (int)(it / t.n_pad), y = (int)(it % t.n_pad);
        const int a = g / b;
        const long long row = (long long)(g % b) * ny + y;
        uint32_t* out = ss_k + it * t.ldw;
        int tot = 0;
        if (PACKED) {
            for (int k0 = 0; k0 < words; k0 += 32) {
                const int k = k0 + lane;
                uint32_t wd = 0;
                if (y < ny && k < words) {
                    wd = src.u32(0, a * n_v + k / nw_l)[row * nw_l + k % nw_l];
                }
                if (k < words) out[k] = wd;
                tot += __reduce_add_sync(BABBLE_FULL_MASK, __popc(wd));
            }
        } else {
#pragma unroll 4
            for (int k = 0; k < words; ++k) {
                const long long w = 32LL * k + lane;
                int s = 0;
                if (y < ny && w < cols) {
                    s = src.u8(0, a * n_v + (int)(w / nw_l))[row * nw_l + w % nw_l] != 0;
                }
                const unsigned bits = __ballot_sync(BABBLE_FULL_MASK, s);
                if (lane == 0) out[k] = bits;
                tot += __popc(bits);
            }
        }
        if (lane == 0) {
            int ax = 0;
            if (y < ny) {
                ax = tot * 4 + (src.u8(3, a * n_v)[row] ? 2 : 0) + (src.u8(2, a * n_v)[row] ? 1 : 0);
            }
            aux_k[it] = ax;
        }
    }
    // (1b) the d = 1 votes of round g: word k of column x, a lane per column
    const int xb_n = (n_x + 31) / 32;
    for (long long it = warp; it < (long long)g_end * words * xb_n; it += warps) {
        const int g = (int)(it / ((long long)words * xb_n));
        const int rem = (int)(it % ((long long)words * xb_n));
        const int k = rem / xb_n;
        const int x = (rem % xb_n) * 32 + lane;
        if (x >= n_x) continue;
        const int a = g / b, bb = g % b;
        uint32_t wd = 0;
        if (PACKED) {
            wd = src.u32(1, a * n_v + k / nw_l)[((long long)bb * n_x + x) * nw_l + k % nw_l];
        } else {
            for (int q = 0; q < 32; ++q) {
                const long long w = 32LL * k + q;
                if (w >= cols) break;
                const uint8_t* vs = src.u8(1, a * n_v + (int)(w / nw_l));
                wd |= (uint32_t)(vs[((long long)bb * nw_l + w % nw_l) * n_x + x] != 0) << q;
            }
        }
        vt[((long long)g * n_x + x) * words + k] = wd;
    }
    // (1c) the rows that do not vote: nothing decided
    const long long rest = (long long)(src.r_pad - g_end) * n_x;
    for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < rest;
         it += (long long)gridDim.x * blockDim.x) {
        src.done(g_end + (int)(it / n_x), (int)(it % n_x), false, false);
    }
    fv_fence_proxy_async_global();
    unsigned int target = 0;
    babble_grid_sync(bar, target);
    fv_fence_proxy_async_global();

    // (2) the vote, persistent blocks over (round g < g_end, column tile)
    const int tiles = (n_x + FV_COLS - 1) / FV_COLS;
    for (int task = blockIdx.x; task < g_end * tiles; task += gridDim.x) {
        const int g = task / tiles;
        fame_task<WMAX>(src, t, g, (task % tiles) * FV_COLS, lr - g, n_participants,
                        super_majority, fv_smem);
    }
}

// ptrs: (7, n_pos) int64 device addresses in device memory (see above).
// Scratch: ss_k (r_pad, 32 W, W | 1) and aux_k (r_pad, 32 W) int32, vt
// (r_pad, N_x, W) words, bar one word (zeroed here). W: the row's words,
// n_v nw_l packed, ceil(n_v nw_l / 32) wide, at most 603 (fv_stages).
extern "C" int babble_shard_fame_grid(
    const int64_t* ptrs, uint32_t* ss_k, int32_t* aux_k, uint32_t* vt, int32_t* bar,
    const int32_t* last_round, int n_pos, int n_v, int b_rows, int ny, int nw_l, int n_x,
    int packed, int n_participants, int super_majority, int device, void* stream) {
    BABBLE_CHECK(cudaSetDevice(device));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_pos < 1 || n_v < 1 || n_pos % n_v || b_rows < 1 || n_x < 1 || nw_l < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const int words = packed ? n_v * nw_l : (n_v * nw_l + 31) / 32;
    if (fv_stages(words) < 2) return (int)cudaErrorInvalidValue;
    const int r_pad = (n_pos / n_v) * b_rows;
    const FameTables t = fv_tables(ss_k, aux_k, words);
    const ShardSrc src{reinterpret_cast<const long long*>(ptrs), vt, n_pos, n_v, b_rows, n_x,
                       words, r_pad};
    const size_t smem = (size_t)fv_smem_bytes(words);
    const long long tasks = (long long)r_pad * ((n_x + FV_COLS - 1) / FV_COLS);
    const long long rows = ((long long)r_pad * t.n_pad + FV_COLS) / (FV_COLS + 1);
    BABBLE_CHECK(cudaMemsetAsync(bar, 0, sizeof(int32_t), s));
    unsigned int* bar_u = reinterpret_cast<unsigned int*>(bar);
    return fv_dispatch(words, [&](auto w) {
        constexpr int WMAX = decltype(w)::value;
        auto kernel = packed ? &sf_grid<WMAX, true> : &sf_grid<WMAX, false>;
        BABBLE_CHECK(babble_allow_smem(kernel, smem));
        int g = 0;
        BABBLE_CHECK(babble_coop_blocks(kernel, FV_THREADS, smem, device,
                                        tasks > rows ? tasks : rows, &g));
        int ny_ = ny, nw_l_ = nw_l, np_ = n_participants, sm_ = super_majority;
        uint32_t* ss_k_ = ss_k;
        int32_t* aux_k_ = aux_k;
        uint32_t* vt_ = vt;
        const int32_t* lr_ = last_round;
        void* args[] = {
            (void*)&src, (void*)&t, (void*)&ss_k_, (void*)&aux_k_, (void*)&vt_, (void*)&bar_u,
            (void*)&lr_, (void*)&ny_, (void*)&nw_l_, (void*)&np_, (void*)&sm_,
        };
        BABBLE_CHECK(cudaLaunchCooperativeKernel((const void*)kernel, dim3(g), dim3(FV_THREADS),
                                                 args, smem, s));
        BABBLE_CHECK_LAUNCH();
        return 0;
    });
}
